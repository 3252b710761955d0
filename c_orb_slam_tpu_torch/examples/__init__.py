"""Dataset drivers of the port, the counterparts of the JAX package's
examples/ (reference: the Examples/*.cc binaries). Run one as a module:

    python3 -m c_orb_slam_tpu_torch.examples.rgbd_tum <settings.yaml> <sequence> \
        --associations <file> [--device cuda|cpu] [--save-map map.npz]

Every driver runs on the CUDA device unless given --device cpu, and
exits nonzero without a CUDA device rather than carry on on the CPU.
"""
