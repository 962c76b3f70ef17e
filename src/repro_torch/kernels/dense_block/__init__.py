"""Dense-layer kernels of the paper's wide MLP-DenseNet, each a CUDA kernel
for tensors on the card and its plain PyTorch version for tensors on the
CPU:

* ``stack.py`` — the fused L-layer stack, forward and backward
  (``csrc/dense_stack_fwd.cu``, ``csrc/dense_stack_bwd.cu``).
  ``core.blocks.mlp_block_apply`` routes here under ``backend="fused"`` for
  mlp | densenet | d2rl with swish | silu | relu | tanh | identity and no
  batch norm; every other config keeps the plain layer loop.
* ``dense_block.py`` / ``ops.py`` — one fused dense layer
  ``act(x @ w + b)`` and ``dense_concat_matmul``, the DenseNet layer over
  column segments in one launch (``csrc/fused_dense.cu``; plain versions in
  ``ref.py``)."""
