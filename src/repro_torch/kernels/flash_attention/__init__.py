"""Forward flash attention (``flash_attention``, ``ops.gqa_flash``): a CUDA
kernel for tensors on the card (``csrc/flash_attention.cu``), the plain
PyTorch attention of ``ref`` for tensors on the CPU."""
