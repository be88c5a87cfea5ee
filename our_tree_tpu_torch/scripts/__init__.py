"""The reference's operator tools that mean something on the card.

Each runs as ``python -m our_tree_tpu_torch.scripts.<name>`` and takes
``--device`` (``cuda``, the default, raising without a card; ``cpu`` for the
plain versions):

* ``fuzz_parity``: randomized bit-parity of ``AES`` and the sharded layer
  against a C oracle, outputs and resume states (``scripts/fuzz_parity.py``);
* ``profile_ctr``: the CTR path's components timed alone, each in a child
  process (``scripts/profile_ctr.py``);
* ``batch_streams_scaling``: cbc-batch and rc4-batch at a fixed total over
  a swept stream count (``scripts/batch_streams_scaling.py``);
* ``arc4_device_keygen``: one ARC4 keystream on the card against the native
  C keygen (``scripts/arc4_device_keygen.py``).

``oracle`` is the port's own copy of the reference's ctypes oracle binding
(``scripts/gen_golden.py``) and the native C tier's oracle for hosts
without the reference checkout. Nothing here imports JAX, the JAX package
or the repo's ``scripts/``.
"""
