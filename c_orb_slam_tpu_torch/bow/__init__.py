"""Bag-of-binary-words place recognition (DBoW2 equivalent on tensors).

Counterpart of c_orb_slam_tpu/bow (reference: Thirdparty/DBoW2 —
TemplatedVocabulary.h, FORB.cpp, BowVector/FeatureVector;
KeyFrameDatabase.cc). The vocabulary is dense per-level arrays, the
transform a batched fixed-depth descent, and a query is scored against
every keyframe in one batched gather: no inverted file.
"""

from c_orb_slam_tpu_torch.bow.vocab import Vocabulary, train_vocabulary
from c_orb_slam_tpu_torch.bow.database import KeyFrameDatabase

__all__ = ["Vocabulary", "train_vocabulary", "KeyFrameDatabase"]
