/* ARC4 with the three-phase split (setup / prep / crypt).
 *
 * The phase split — sequential keystream generation separated from the
 * data-parallel XOR — is the reference repo's one original design idea
 * (SURVEY.md §0; arc4.c:72-112) and is preserved here as API shape. The
 * implementation is the textbook KSA/PRGA, written fresh; state {x, y, m}
 * persists across ot_arc4_prep calls so a stream can resume, matching the
 * cross-call resumability of the reference (arc4.c:93-94). The XOR phase is
 * ot_xor in ot_parallel.c.
 */
#include "ot_crypt.h"

void ot_arc4_setup(ot_arc4_ctx *ctx, const uint8_t *key, size_t keylen) {
    ctx->x = 0;
    ctx->y = 0;
    for (int i = 0; i < 256; i++) ctx->m[i] = (uint8_t)i;
    if (keylen == 0) return; /* identity permutation; callers validate */
    int j = 0;
    for (int i = 0; i < 256; i++) {
        j = (j + ctx->m[i] + key[(size_t)i % keylen]) & 0xFF;
        uint8_t t = ctx->m[i];
        ctx->m[i] = ctx->m[j];
        ctx->m[j] = t;
    }
}

void ot_arc4_prep(ot_arc4_ctx *ctx, uint8_t *keystream, size_t len) {
    int x = ctx->x, y = ctx->y;
    uint8_t *m = ctx->m;
    for (size_t i = 0; i < len; i++) {
        x = (x + 1) & 0xFF;
        uint8_t a = m[x];
        y = (y + a) & 0xFF;
        uint8_t b = m[y];
        m[x] = b;
        m[y] = a;
        keystream[i] = m[(a + b) & 0xFF];
    }
    ctx->x = x;
    ctx->y = y;
}
