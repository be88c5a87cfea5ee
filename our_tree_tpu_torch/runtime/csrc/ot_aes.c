/* AES from FIPS-197, byte-matrix formulation.
 *
 * Deliberately NOT the reference's implementation style: the reference
 * (vendored PolarSSL, aes-modes/aes.c) packs the state into four
 * little-endian uint32 words and folds SubBytes+ShiftRows+MixColumns into
 * 32-bit T-table lookups; this file keeps the FIPS byte matrix and applies
 * each transformation directly, with the S-box generated at first use from
 * GF(2^8) arithmetic (the same derivation ops/gf.py uses in Python).
 * Compiled -O2 this is plenty for the correctness/portability backend; the
 * throughput story belongs to the TPU engines.
 */
#include "ot_crypt.h"

#include <pthread.h>
#include <string.h>

/* ---------------------------------------------------------------- GF(2^8) */

static uint8_t gf_xtime(uint8_t a) {
    return (uint8_t)((a << 1) ^ ((a >> 7) * 0x1B));
}

static uint8_t gf_mul(uint8_t a, uint8_t b) {
    uint8_t r = 0;
    while (b) {
        if (b & 1) r ^= a;
        b >>= 1;
        a = gf_xtime(a);
    }
    return r;
}

/* S-boxes generated once: S(x) = affine(x^254). pthread_once because
 * ctypes callers drop the GIL, so two threads may race the first setkey. */
static uint8_t SBOX[256], ISBOX[256];
static pthread_once_t tables_once = PTHREAD_ONCE_INIT;

static void gen_tables(void) {
    for (int x = 0; x < 256; x++) {
        /* x^254 by square-and-multiply (254 = 0b11111110). */
        uint8_t inv = 1, base = (uint8_t)x;
        for (int e = 254; e; e >>= 1) {
            if (e & 1) inv = gf_mul(inv, base);
            base = gf_mul(base, base);
        }
        uint8_t s = 0x63;
        for (int i = 0; i < 8; i++) {
            uint8_t bit = (uint8_t)((inv >> i) ^ (inv >> ((i + 4) & 7)) ^
                                    (inv >> ((i + 5) & 7)) ^
                                    (inv >> ((i + 6) & 7)) ^
                                    (inv >> ((i + 7) & 7))) & 1u;
            s ^= (uint8_t)(bit << i);
        }
        SBOX[x] = s;
        ISBOX[s] = (uint8_t)x;
    }
}

/* ------------------------------------------------------------ key schedule */

int ot_aes_setkey(ot_aes_ctx *ctx, const uint8_t *key, int keybits) {
    pthread_once(&tables_once, gen_tables);
    int nk;
    switch (keybits) {
        case 128: nk = 4;  ctx->nr = 10; break;
        case 192: nk = 6;  ctx->nr = 12; break;
        case 256: nk = 8;  ctx->nr = 14; break;
        default:  return -1;
    }
    int nwords = 4 * (ctx->nr + 1);
    uint8_t w[60][4];
    memcpy(w, key, (size_t)(4 * nk));
    uint8_t rcon = 1;
    for (int i = nk; i < nwords; i++) {
        uint8_t t[4];
        memcpy(t, w[i - 1], 4);
        if (i % nk == 0) {
            uint8_t tmp = t[0]; /* RotWord */
            t[0] = SBOX[t[1]] ^ rcon;
            t[1] = SBOX[t[2]];
            t[2] = SBOX[t[3]];
            t[3] = SBOX[tmp];
            rcon = gf_xtime(rcon);
        } else if (nk > 6 && i % nk == 4) {
            for (int j = 0; j < 4; j++) t[j] = SBOX[t[j]];
        }
        for (int j = 0; j < 4; j++) w[i][j] = w[i - nk][j] ^ t[j];
    }
    memcpy(ctx->rk, w, (size_t)(4 * nwords));
    return 0;
}

/* ------------------------------------------------------------- block core */

static void add_round_key(uint8_t s[16], const uint8_t rk[16]) {
    for (int i = 0; i < 16; i++) s[i] ^= rk[i];
}

static void sub_shift(uint8_t s[16]) {
    /* SubBytes + ShiftRows in one pass: byte i sits at row i%4, col i/4;
     * row r rotates left by r, so dst[4c+r] = S(src[4((c+r)%4)+r]). */
    uint8_t t[16];
    for (int c = 0; c < 4; c++)
        for (int r = 0; r < 4; r++)
            t[4 * c + r] = SBOX[s[4 * ((c + r) & 3) + r]];
    memcpy(s, t, 16);
}

static void inv_sub_shift(uint8_t s[16]) {
    uint8_t t[16];
    for (int c = 0; c < 4; c++)
        for (int r = 0; r < 4; r++)
            t[4 * c + r] = ISBOX[s[4 * ((c - r) & 3) + r]];
    memcpy(s, t, 16);
}

static void mix_columns(uint8_t s[16]) {
    for (int c = 0; c < 4; c++) {
        uint8_t *a = s + 4 * c;
        uint8_t all = (uint8_t)(a[0] ^ a[1] ^ a[2] ^ a[3]);
        uint8_t a0 = a[0];
        a[0] ^= all ^ gf_xtime((uint8_t)(a[0] ^ a[1]));
        a[1] ^= all ^ gf_xtime((uint8_t)(a[1] ^ a[2]));
        a[2] ^= all ^ gf_xtime((uint8_t)(a[2] ^ a[3]));
        a[3] ^= all ^ gf_xtime((uint8_t)(a[3] ^ a0));
    }
}

static void inv_mix_columns(uint8_t s[16]) {
    for (int c = 0; c < 4; c++) {
        uint8_t *a = s + 4 * c;
        uint8_t b[4];
        for (int r = 0; r < 4; r++)
            b[r] = (uint8_t)(gf_mul(14, a[r]) ^ gf_mul(11, a[(r + 1) & 3]) ^
                             gf_mul(13, a[(r + 2) & 3]) ^
                             gf_mul(9, a[(r + 3) & 3]));
        memcpy(a, b, 4);
    }
}

void ot_aes_encrypt_block(const ot_aes_ctx *ctx, const uint8_t in[16],
                          uint8_t out[16]) {
    uint8_t s[16];
    memcpy(s, in, 16);
    add_round_key(s, ctx->rk[0]);
    for (int r = 1; r < ctx->nr; r++) {
        sub_shift(s);
        mix_columns(s);
        add_round_key(s, ctx->rk[r]);
    }
    sub_shift(s);
    add_round_key(s, ctx->rk[ctx->nr]);
    memcpy(out, s, 16);
}

void ot_aes_decrypt_block(const ot_aes_ctx *ctx, const uint8_t in[16],
                          uint8_t out[16]) {
    /* Straight inverse cipher over the encryption schedule (FIPS-197 §5.3)
     * — no InvMixColumns-folded "equivalent" schedule needed. */
    uint8_t s[16];
    memcpy(s, in, 16);
    add_round_key(s, ctx->rk[ctx->nr]);
    inv_sub_shift(s);
    for (int r = ctx->nr - 1; r >= 1; r--) {
        add_round_key(s, ctx->rk[r]);
        inv_mix_columns(s);
        inv_sub_shift(s);
    }
    add_round_key(s, ctx->rk[0]);
    memcpy(out, s, 16);
}

/* ------------------------------------------------- sequential chain modes */

void ot_aes_cbc_encrypt(const ot_aes_ctx *ctx, uint8_t iv[16],
                        const uint8_t *in, uint8_t *out, size_t nblocks) {
    uint8_t x[16];
    for (size_t b = 0; b < nblocks; b++) {
        for (int i = 0; i < 16; i++) x[i] = (uint8_t)(in[16 * b + i] ^ iv[i]);
        ot_aes_encrypt_block(ctx, x, out + 16 * b);
        memcpy(iv, out + 16 * b, 16);
    }
}

void ot_aes_cfb128(const ot_aes_ctx *ctx, int encrypt, int *iv_off,
                   uint8_t iv[16], const uint8_t *in, uint8_t *out,
                   size_t len) {
    int n = *iv_off;
    for (size_t i = 0; i < len; i++) {
        if (n == 0) ot_aes_encrypt_block(ctx, iv, iv);
        uint8_t c;
        if (encrypt) {
            c = (uint8_t)(in[i] ^ iv[n]);
            iv[n] = c;
        } else {
            c = (uint8_t)(in[i] ^ iv[n]);
            iv[n] = in[i];
        }
        out[i] = c;
        n = (n + 1) & 0x0F;
    }
    *iv_off = n;
}
