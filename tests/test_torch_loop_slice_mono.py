"""The monocular half of tests/test_torch_loop_slice.py (its docstring has
the sequence, the size and the gates): the orbit through both packages
with free scale, where the Sim3 alignment must estimate and correct the
scale drift (reference: LoopClosing.cc:38-41 mbFixScale). A file of its
own so that the stereo and the monocular run go to different test
processes.
"""

import torch

from test_torch_loop_slice import OrbitChecks

# The longest file of the suite: a second intra-op thread for its matrix
# products (the fuse's dense distance matrices, the local BA's Schur
# complement), which are most of its time.
torch.set_num_threads(2)


class TestMonoOrbit(OrbitChecks):
    mono = True
