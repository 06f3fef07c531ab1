"""PyTorch/CUDA port of docqa_tpu's /ask path for one NVIDIA H100.

The module layout mirrors ``docqa_tpu`` so each counterpart is easy to
find.  This package imports ``torch`` and numpy only: never ``jax`` and
never ``docqa_tpu`` (what it needs from there it keeps its own copy of).

Every entry point (``EncoderEngine``, ``GenerateEngine``, ``VectorStore``,
``FusedRetriever``, ``QAService``) takes ``device=``, defaulting to
``"cuda"``; without a card it raises unless the caller passes
``device="cpu"``.  On a CUDA tensor attention runs the hand-written Hopper
kernel in ``csrc/flash_attention.cu``; on a CPU tensor it runs the plain
PyTorch version the kernel is held against.  The kernel is forward-only:
the trainers (``training/``) run the plain version under autograd.
"""
