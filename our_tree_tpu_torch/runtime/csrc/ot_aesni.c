/* Hardware AES path: AES-NI bulk chunk workers.
 *
 * This is the framework's equivalent of the reference's SIMD backend
 * (aes-modes/aesni.c — SURVEY.md §2 component #2), built differently:
 * the reference expands keys with _mm_aeskeygenassist (AES-256 only) and
 * processes one block per loop iteration; here the portable core's byte
 * round keys (ot_aes.c, any key size) are simply loaded into xmm
 * registers, decryption uses the spec's equivalent-inverse-cipher
 * (_mm_aesimc-transformed middle keys, FIPS-197 §5.3.5), and the bulk
 * loops process STRIDE blocks interleaved so the aesenc pipeline stays
 * full — one in-flight block per issue slot, the ILP analogue of the
 * bitsliced engine's 32-blocks-per-lane packing.
 *
 * Everything is runtime-gated on cpuid (__builtin_cpu_supports), so the
 * portable core remains the fallback and OT_C_FORCE_PORTABLE pins it for
 * parity tests.
 */
#include "ot_crypt.h"

#if defined(__x86_64__) || defined(__i386__)
#include <string.h>
#include <wmmintrin.h>

int ot_aesni_available(void) {
    return __builtin_cpu_supports("aes") && __builtin_cpu_supports("sse2");
}

#define STRIDE 8

typedef struct {
    __m128i k[15];
} keyvec_t;

static void load_enc_keys(const ot_aes_ctx *ctx, keyvec_t *kv) {
    for (int i = 0; i <= ctx->nr; i++)
        kv->k[i] = _mm_loadu_si128((const __m128i *)ctx->rk[i]);
}

/* Equivalent inverse cipher: dk[0] = rk[nr], middle keys InvMixColumns-
 * transformed, dk[nr] = rk[0]. */
static void load_dec_keys(const ot_aes_ctx *ctx, keyvec_t *kv) {
    int nr = ctx->nr;
    kv->k[0] = _mm_loadu_si128((const __m128i *)ctx->rk[nr]);
    for (int i = 1; i < nr; i++)
        kv->k[i] =
            _mm_aesimc_si128(_mm_loadu_si128((const __m128i *)ctx->rk[nr - i]));
    kv->k[nr] = _mm_loadu_si128((const __m128i *)ctx->rk[0]);
}

/* w blocks (w <= STRIDE) through the full pipeline, interleaved. */
static void enc_group(const keyvec_t *kv, int nr, __m128i b[STRIDE], int w) {
    for (int i = 0; i < w; i++) b[i] = _mm_xor_si128(b[i], kv->k[0]);
    for (int r = 1; r < nr; r++)
        for (int i = 0; i < w; i++) b[i] = _mm_aesenc_si128(b[i], kv->k[r]);
    for (int i = 0; i < w; i++) b[i] = _mm_aesenclast_si128(b[i], kv->k[nr]);
}

static void dec_group(const keyvec_t *kv, int nr, __m128i b[STRIDE], int w) {
    for (int i = 0; i < w; i++) b[i] = _mm_xor_si128(b[i], kv->k[0]);
    for (int r = 1; r < nr; r++)
        for (int i = 0; i < w; i++) b[i] = _mm_aesdec_si128(b[i], kv->k[r]);
    for (int i = 0; i < w; i++) b[i] = _mm_aesdeclast_si128(b[i], kv->k[nr]);
}

void ot_aesni_ecb_chunk(const ot_aes_ctx *ctx, int encrypt, const uint8_t *in,
                        uint8_t *out, size_t nblocks) {
    keyvec_t kv;
    __m128i b[STRIDE];
    if (encrypt)
        load_enc_keys(ctx, &kv);
    else
        load_dec_keys(ctx, &kv);
    for (size_t off = 0; off < nblocks; off += STRIDE) {
        int w = (int)(nblocks - off < STRIDE ? nblocks - off : STRIDE);
        for (int i = 0; i < w; i++)
            b[i] = _mm_loadu_si128((const __m128i *)(in + 16 * (off + i)));
        if (encrypt)
            enc_group(&kv, ctx->nr, b, w);
        else
            dec_group(&kv, ctx->nr, b, w);
        for (int i = 0; i < w; i++)
            _mm_storeu_si128((__m128i *)(out + 16 * (off + i)), b[i]);
    }
}

/* 128-bit big-endian increment, local copy (ot_parallel.c owns the
 * canonical chunk-offset add; this is the per-block ripple). */
static void be_inc(uint8_t ctr[16]) {
    for (int i = 15; i >= 0; i--)
        if (++ctr[i]) break;
}

void ot_aesni_ctr_chunk(const ot_aes_ctx *ctx, uint8_t ctr[16],
                        const uint8_t *in, uint8_t *out, size_t nblocks,
                        size_t tail) {
    keyvec_t kv;
    __m128i b[STRIDE];
    load_enc_keys(ctx, &kv);
    /* The counter lives in two big-endian-valued qwords in registers; each
     * block is built with one bswap pair + a vector set. The earlier
     * per-block memcpy + byte-ripple through a stack buffer cost a
     * store-forwarding round-trip per block that outweighed the AES
     * pipeline itself. The 128-bit ripple semantics are unchanged:
     * ++lo == 0 carries into hi (reference aes-modes/aes.c:879-884). */
    uint64_t hi, lo;
    memcpy(&hi, ctr, 8);
    memcpy(&lo, ctr + 8, 8);
    hi = __builtin_bswap64(hi);
    lo = __builtin_bswap64(lo);
    for (size_t off = 0; off < nblocks; off += STRIDE) {
        int w = (int)(nblocks - off < STRIDE ? nblocks - off : STRIDE);
        for (int i = 0; i < w; i++) {
            b[i] = _mm_set_epi64x((long long)__builtin_bswap64(lo),
                                  (long long)__builtin_bswap64(hi));
            if (++lo == 0) hi++;
        }
        enc_group(&kv, ctx->nr, b, w);
        for (int i = 0; i < w; i++) {
            __m128i d =
                _mm_loadu_si128((const __m128i *)(in + 16 * (off + i)));
            _mm_storeu_si128((__m128i *)(out + 16 * (off + i)),
                             _mm_xor_si128(d, b[i]));
        }
    }
    /* Write the advanced counter back for the caller/tail (in-place
     * contract of this function, matching the resume-state semantics). */
    {
        uint64_t hb = __builtin_bswap64(hi), lb = __builtin_bswap64(lo);
        memcpy(ctr, &hb, 8);
        memcpy(ctr + 8, &lb, 8);
    }
    if (tail) {
        uint8_t ks[16];
        b[0] = _mm_loadu_si128((const __m128i *)ctr);
        be_inc(ctr);
        enc_group(&kv, ctx->nr, b, 1);
        _mm_storeu_si128((__m128i *)ks, b[0]);
        for (size_t i = 0; i < tail; i++)
            out[16 * nblocks + i] = (uint8_t)(in[16 * nblocks + i] ^ ks[i]);
    }
}

void ot_aesni_cbc_dec_chunk(const ot_aes_ctx *ctx, const uint8_t prev0[16],
                            const uint8_t *in, uint8_t *out, size_t nblocks) {
    keyvec_t kv;
    __m128i b[STRIDE], prev[STRIDE + 1];
    load_dec_keys(ctx, &kv);
    prev[0] = _mm_loadu_si128((const __m128i *)prev0);
    for (size_t off = 0; off < nblocks; off += STRIDE) {
        int w = (int)(nblocks - off < STRIDE ? nblocks - off : STRIDE);
        for (int i = 0; i < w; i++) {
            prev[i + 1] =
                _mm_loadu_si128((const __m128i *)(in + 16 * (off + i)));
            b[i] = prev[i + 1];
        }
        dec_group(&kv, ctx->nr, b, w);
        for (int i = 0; i < w; i++)
            _mm_storeu_si128((__m128i *)(out + 16 * (off + i)),
                             _mm_xor_si128(b[i], prev[i]));
        prev[0] = prev[w];
    }
}

#else /* non-x86: portable core only */

int ot_aesni_available(void) { return 0; }
void ot_aesni_ecb_chunk(const ot_aes_ctx *ctx, int encrypt, const uint8_t *in,
                        uint8_t *out, size_t nblocks) {
    (void)ctx; (void)encrypt; (void)in; (void)out; (void)nblocks;
}
void ot_aesni_ctr_chunk(const ot_aes_ctx *ctx, uint8_t ctr[16],
                        const uint8_t *in, uint8_t *out, size_t nblocks,
                        size_t tail) {
    (void)ctx; (void)ctr; (void)in; (void)out; (void)nblocks; (void)tail;
}
void ot_aesni_cbc_dec_chunk(const ot_aes_ctx *ctx, const uint8_t prev0[16],
                            const uint8_t *in, uint8_t *out, size_t nblocks) {
    (void)ctx; (void)prev0; (void)in; (void)out; (void)nblocks;
}

#endif
