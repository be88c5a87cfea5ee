"""PyTorch / CUDA port of the AES-CTR main path for an NVIDIA H100.

A package of its own beside ``our_tree_tpu`` (the JAX reference). It
imports torch and numpy and nothing of JAX or of the reference package.
u32 words travel in ``torch.int32`` tensors with the same bits.

Layers, from the user down to the card:

* ``models.aes`` - the ``AES`` context (byte-granular ``crypt_ctr``), the
  engine registry and ``ctr_crypt_words``;
* ``ops.cuda_aes`` - the fused counter-synthesising CTR wrapper, which
  launches ``csrc/ctr_gen.cu`` for CUDA tensors and runs its plain torch
  version (``ops.bitslice``) for CPU tensors;
* ``runtime.cuda_build`` - builds ``csrc/*.cu`` with ``nvcc`` at first use;
* ``bench`` - ``python -m our_tree_tpu_torch.bench``, the chained CTR
  throughput line of the root ``bench.py``.
"""
