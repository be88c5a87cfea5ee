"""Authenticated modes (AES-GCM) on the card (``our_tree_tpu.aead``).

``ghash.py`` is the host half: GHASH on ints (the reference the card's rows
are held against and the per-request tail), the single-block AES with which
H = E_K(0^128) is derived, GCM's inc32 counters, J0 and the length block, and
GCM wholly on the host. ``gcm.py`` is the card half and the public API: the
dispatch seam ``gcm_crypt_ghash_words`` (multi-key CTR, then the GHASH scan
kernel), ``ghash_words``, the constant-time tag compare, ``gcm_seal`` and
``gcm_open``.
"""
