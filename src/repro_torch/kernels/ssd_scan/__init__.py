"""The Mamba2 SSD chunk (``ssd_scan.ssd_chunk_dual``, the whole-sequence
``ops.ssd_chunked_kernel``): a CUDA kernel for tensors on the card
(``csrc/ssd_scan.cu``), the plain PyTorch scan of ``ref`` for tensors on
the CPU."""
