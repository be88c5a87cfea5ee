/* our-tree-tpu native runtime: clean-room symmetric-cipher cores.
 *
 * This is the framework's C layer — the role the portable C / AES-NI /
 * CUDA trio plays in the reference repo (SURVEY.md §1 L0/L1), rebuilt from
 * the specifications (FIPS-197, NIST SP 800-38A, the ARC4 folklore spec)
 * rather than ported: the cipher state is the FIPS byte matrix, not the
 * reference's 32-bit T-table words (aes-modes/aes.c:601-645), and the only
 * lookup tables are the runtime-generated S-boxes.
 *
 * Bulk entry points are pthread-parallel with the same work split the
 * reference harnesses use — contiguous chunks, one worker each
 * (aes-modes/test.c:33-35) — so `--backend=c` benchmarks measure the same
 * parallelism scheme on CPU that the TPU backend expresses with shard_map.
 */
#ifndef OT_CRYPT_H
#define OT_CRYPT_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
    int nr;               /* rounds: 10/12/14 */
    uint8_t rk[15][16];   /* round keys as byte blocks, enc schedule */
} ot_aes_ctx;

/* keybits in {128, 192, 256}; returns 0 on success, -1 on bad size. */
int ot_aes_setkey(ot_aes_ctx *ctx, const uint8_t *key, int keybits);

void ot_aes_encrypt_block(const ot_aes_ctx *ctx, const uint8_t in[16],
                          uint8_t out[16]);
void ot_aes_decrypt_block(const ot_aes_ctx *ctx, const uint8_t in[16],
                          uint8_t out[16]);

/* Bulk ECB over nblocks 16-byte blocks, split across nthreads workers. */
void ot_aes_ecb(const ot_aes_ctx *ctx, int encrypt, const uint8_t *in,
                uint8_t *out, size_t nblocks, int nthreads);

/* CTR with a 128-bit big-endian post-increment counter (the reference's
 * semantics, aes-modes/aes.c:869-901); len in bytes, any length. Each
 * worker derives its chunk's counter offset — the seam bookkeeping of
 * SURVEY.md §7 hard part #6, on CPU. nonce is advanced in place by the
 * number of whole blocks consumed so streams can resume. */
void ot_aes_ctr(const ot_aes_ctx *ctx, uint8_t nonce[16], const uint8_t *in,
                uint8_t *out, size_t len, int nthreads);

/* CBC (SP 800-38A): encrypt is inherently sequential; decrypt is
 * chunk-parallel (each chunk's chain needs only ciphertext). iv updated in
 * place to the last ciphertext block, as in the reference (aes.c:792,807). */
void ot_aes_cbc_encrypt(const ot_aes_ctx *ctx, uint8_t iv[16],
                        const uint8_t *in, uint8_t *out, size_t nblocks);
void ot_aes_cbc_decrypt(const ot_aes_ctx *ctx, uint8_t iv[16],
                        const uint8_t *in, uint8_t *out, size_t nblocks,
                        int nthreads);

/* CFB128 with byte-granular resume offset, semantics of aes.c:822-863. */
void ot_aes_cfb128(const ot_aes_ctx *ctx, int encrypt, int *iv_off,
                   uint8_t iv[16], const uint8_t *in, uint8_t *out,
                   size_t len);

/* Hardware AES (AES-NI) chunk workers — the framework's SIMD backend
 * (reference component #2 role). Runtime-gated: callers must check
 * ot_aesni_available(); the bulk dispatchers in ot_parallel.c do this and
 * fall back to the portable core (OT_C_FORCE_PORTABLE env pins portable
 * for parity testing). Chunk functions mirror the per-worker loops. */
int ot_aesni_available(void);
void ot_aesni_ecb_chunk(const ot_aes_ctx *ctx, int encrypt, const uint8_t *in,
                        uint8_t *out, size_t nblocks);
void ot_aesni_ctr_chunk(const ot_aes_ctx *ctx, uint8_t ctr[16],
                        const uint8_t *in, uint8_t *out, size_t nblocks,
                        size_t tail);
void ot_aesni_cbc_dec_chunk(const ot_aes_ctx *ctx, const uint8_t prev0[16],
                            const uint8_t *in, uint8_t *out, size_t nblocks);

/* ARC4 in the reference's three phases (its one original design idea,
 * SURVEY.md §0): setup (KSA), prep (sequential PRGA -> keystream buffer),
 * crypt (parallel XOR). State persists across prep calls. */
typedef struct {
    int x, y;
    uint8_t m[256];
} ot_arc4_ctx;

void ot_arc4_setup(ot_arc4_ctx *ctx, const uint8_t *key, size_t keylen);
void ot_arc4_prep(ot_arc4_ctx *ctx, uint8_t *keystream, size_t len);
void ot_xor(const uint8_t *data, const uint8_t *keystream, uint8_t *out,
            size_t len, int nthreads);

#ifdef __cplusplus
}
#endif
#endif /* OT_CRYPT_H */
