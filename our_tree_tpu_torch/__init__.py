"""PyTorch / CUDA port of the framework for an NVIDIA H100.

A package of its own beside ``our_tree_tpu`` (the JAX reference). It
imports torch and numpy and nothing of JAX or of the reference package.
u32 words travel in ``torch.int32`` tensors with the same bits.

Layers, from the user down to the card:

* ``harness.decrypt`` - the hex CLI (``python -m
  our_tree_tpu_torch.harness.decrypt``), every mode, ``--device``;
* ``models.base`` - ``BlockCipher`` / ``AESCipher`` (ECB behind the
  reference's C++ interface);
* ``models.aes`` - the ``AES`` context (byte-granular ``crypt_ctr``,
  ``crypt_ecb``, ``crypt_cbc``, ``crypt_cfb128`` with their resume state),
  the engine registry and the word-level mode entries;
* ``ops.cuda_aes`` - the kernels' wrappers (fused counter-synthesising CTR,
  ECB encrypt and decrypt), which launch ``csrc/ctr_gen.cu`` and
  ``csrc/ecb.cu`` for CUDA tensors and run their plain torch versions
  (``ops.bitslice``) for CPU tensors; ``ops.block`` is the T-table engine,
  an in-port oracle;
* ``runtime.cuda_build`` - builds ``csrc/*.cu`` with ``nvcc`` at first use;
* ``bench`` - ``python -m our_tree_tpu_torch.bench``, the chained CTR
  throughput line of the root ``bench.py``.
"""
