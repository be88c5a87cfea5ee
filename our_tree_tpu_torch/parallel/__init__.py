"""Multi-device layer over torch.distributed (``our_tree_tpu.parallel``): one
rank a device, each sharded function on this rank's shard."""

from .dist import (  # noqa: F401
    AXIS,
    Mesh,
    arc4_prep_batch_sharded,
    block_cyclic_to_contiguous,
    cbc_decrypt_sharded,
    cbc_encrypt_batch_sharded,
    cfb128_decrypt_sharded,
    ctr_crypt_sharded,
    ecb_crypt_sharded,
    gather_for_verification,
    make_mesh,
    shard_rows,
    xor_sharded,
)
