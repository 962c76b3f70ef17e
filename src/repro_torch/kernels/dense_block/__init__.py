"""The fused MLP-DenseNet stack (``stack.py``): a CUDA forward kernel for
tensors on the card, the plain PyTorch concat loop for tensors on the CPU.
``core.blocks.mlp_block_apply`` routes here under ``backend="fused"`` for
mlp | densenet | d2rl with swish | silu | relu | tanh | identity and no
batch norm; every other config keeps the plain layer loop."""
