"""The replay's device sum-tree (``ops``): CUDA kernels for the sample
descent and the leaf write on tensors on the card (``csrc/replay_tree.cu``),
their plain PyTorch versions (``ref``) for tensors on the CPU."""
