/* pthread-parallel bulk cipher entry points.
 *
 * Work split = the reference harnesses' scheme: a message divided into
 * contiguous chunks, one worker thread each, joined at the end
 * (aes-modes/test.c:33-35,76-86; test.c:50-55). Unlike the reference,
 * chunk seams are computed in whole blocks and CTR workers derive their
 * chunk's counter with a 128-bit add, so any worker count produces
 * bit-identical output (the shard-invariance property the TPU path tests).
 */
#include "ot_crypt.h"

#include <pthread.h>
#include <stdlib.h>
#include <string.h>

#define OT_MAX_THREADS 64

/* Hardware path selection, decided once: AES-NI when the CPU has it and
 * OT_C_FORCE_PORTABLE is unset (the knob parity tests use to compare the
 * two implementations on the same machine). pthread_once, not a bare
 * static: the first callers are the worker threads themselves, which
 * would otherwise race the write (C11 UB, TSan-visible). */
static int aesni_on;
static pthread_once_t aesni_once = PTHREAD_ONCE_INIT;

static void decide_aesni(void) {
    aesni_on = ot_aesni_available() && !getenv("OT_C_FORCE_PORTABLE");
}

static int use_aesni(void) {
    pthread_once(&aesni_once, decide_aesni);
    return aesni_on;
}

/* 128-bit big-endian add: ctr += k. */
static void ctr_add(uint8_t ctr[16], uint64_t k) {
    for (int i = 15; i >= 0 && k; i--) {
        uint64_t v = (uint64_t)ctr[i] + (k & 0xFF);
        ctr[i] = (uint8_t)v;
        k = (k >> 8) + (v >> 8);
    }
}

typedef struct {
    const ot_aes_ctx *ctx;
    const uint8_t *in;
    uint8_t *out;
    size_t nblocks;      /* whole blocks in this chunk */
    size_t tail;         /* trailing bytes (last chunk only, CTR) */
    int encrypt;
    uint8_t ctr[16];     /* chunk-start counter (CTR) / prev block (CBC) */
} job_t;

static void *ecb_worker(void *arg) {
    job_t *j = (job_t *)arg;
    if (use_aesni()) {
        ot_aesni_ecb_chunk(j->ctx, j->encrypt, j->in, j->out, j->nblocks);
        return NULL;
    }
    for (size_t b = 0; b < j->nblocks; b++) {
        if (j->encrypt)
            ot_aes_encrypt_block(j->ctx, j->in + 16 * b, j->out + 16 * b);
        else
            ot_aes_decrypt_block(j->ctx, j->in + 16 * b, j->out + 16 * b);
    }
    return NULL;
}

static void *ctr_worker(void *arg) {
    job_t *j = (job_t *)arg;
    uint8_t ks[16];
    if (use_aesni()) {
        ot_aesni_ctr_chunk(j->ctx, j->ctr, j->in, j->out, j->nblocks, j->tail);
        return NULL;
    }
    for (size_t b = 0; b < j->nblocks; b++) {
        ot_aes_encrypt_block(j->ctx, j->ctr, ks);
        ctr_add(j->ctr, 1);
        for (int i = 0; i < 16; i++)
            j->out[16 * b + i] = (uint8_t)(j->in[16 * b + i] ^ ks[i]);
    }
    if (j->tail) {
        ot_aes_encrypt_block(j->ctx, j->ctr, ks);
        ctr_add(j->ctr, 1);
        for (size_t i = 0; i < j->tail; i++)
            j->out[16 * j->nblocks + i] =
                (uint8_t)(j->in[16 * j->nblocks + i] ^ ks[i]);
    }
    return NULL;
}

static void *cbc_dec_worker(void *arg) {
    /* P_b = D(C_b) ^ C_{b-1}: each chunk only needs the ciphertext block
     * before it, so decryption parallelises where encryption cannot —
     * the same asymmetry the TPU path exploits (models/aes.py). */
    job_t *j = (job_t *)arg;
    uint8_t prev[16], cur[16];
    if (use_aesni()) {
        ot_aesni_cbc_dec_chunk(j->ctx, j->ctr, j->in, j->out, j->nblocks);
        return NULL;
    }
    memcpy(prev, j->ctr, 16);
    for (size_t b = 0; b < j->nblocks; b++) {
        memcpy(cur, j->in + 16 * b, 16);
        ot_aes_decrypt_block(j->ctx, cur, j->out + 16 * b);
        for (int i = 0; i < 16; i++) j->out[16 * b + i] ^= prev[i];
        memcpy(prev, cur, 16);
    }
    return NULL;
}

static int clamp_threads(int nthreads, size_t work_items) {
    if (nthreads < 1) nthreads = 1;
    if (nthreads > OT_MAX_THREADS) nthreads = OT_MAX_THREADS;
    if ((size_t)nthreads > work_items && work_items > 0)
        nthreads = (int)work_items;
    return nthreads;
}

static void run_jobs(void *(*worker)(void *), job_t *jobs, int n) {
    pthread_t tids[OT_MAX_THREADS];
    int spawned[OT_MAX_THREADS] = {0};
    for (int t = 1; t < n; t++)
        spawned[t] = pthread_create(&tids[t], NULL, worker, &jobs[t]) == 0;
    worker(&jobs[0]); /* calling thread does the first chunk */
    for (int t = 1; t < n; t++) {
        if (spawned[t])
            pthread_join(tids[t], NULL);
        else
            worker(&jobs[t]); /* spawn failed: do the chunk inline */
    }
}

void ot_aes_ecb(const ot_aes_ctx *ctx, int encrypt, const uint8_t *in,
                uint8_t *out, size_t nblocks, int nthreads) {
    nthreads = clamp_threads(nthreads, nblocks);
    job_t jobs[OT_MAX_THREADS];
    size_t per = nblocks / (size_t)nthreads, off = 0;
    for (int t = 0; t < nthreads; t++) {
        size_t take = per + ((size_t)t < nblocks % (size_t)nthreads ? 1 : 0);
        jobs[t] = (job_t){ctx, in + 16 * off, out + 16 * off, take, 0,
                          encrypt, {0}};
        off += take;
    }
    run_jobs(ecb_worker, jobs, nthreads);
}

void ot_aes_ctr(const ot_aes_ctx *ctx, uint8_t nonce[16], const uint8_t *in,
                uint8_t *out, size_t len, int nthreads) {
    size_t nblocks = len / 16, tail = len % 16;
    size_t total_blocks = nblocks + (tail ? 1 : 0);
    nthreads = clamp_threads(nthreads, total_blocks ? total_blocks : 1);
    job_t jobs[OT_MAX_THREADS];
    size_t per = nblocks / (size_t)nthreads, off = 0;
    for (int t = 0; t < nthreads; t++) {
        size_t take = per + ((size_t)t < nblocks % (size_t)nthreads ? 1 : 0);
        jobs[t] = (job_t){ctx, in + 16 * off, out + 16 * off, take,
                          (t == nthreads - 1) ? tail : 0, 1, {0}};
        memcpy(jobs[t].ctr, nonce, 16);
        ctr_add(jobs[t].ctr, (uint64_t)off); /* per-chunk counter offset */
        off += take;
    }
    run_jobs(ctr_worker, jobs, nthreads);
    ctr_add(nonce, (uint64_t)(nblocks + (tail ? 1 : 0)));
}

void ot_aes_cbc_decrypt(const ot_aes_ctx *ctx, uint8_t iv[16],
                        const uint8_t *in, uint8_t *out, size_t nblocks,
                        int nthreads) {
    nthreads = clamp_threads(nthreads, nblocks);
    if (nblocks == 0) return;
    job_t jobs[OT_MAX_THREADS];
    size_t per = nblocks / (size_t)nthreads, off = 0;
    uint8_t last[16];
    memcpy(last, in + 16 * (nblocks - 1), 16);
    for (int t = 0; t < nthreads; t++) {
        size_t take = per + ((size_t)t < nblocks % (size_t)nthreads ? 1 : 0);
        jobs[t] = (job_t){ctx, in + 16 * off, out + 16 * off, take, 0, 0, {0}};
        memcpy(jobs[t].ctr, off == 0 ? iv : in + 16 * (off - 1), 16);
        off += take;
    }
    run_jobs(cbc_dec_worker, jobs, nthreads);
    memcpy(iv, last, 16); /* aes.c:792 semantics: iv <- last ciphertext */
}

typedef struct {
    const uint8_t *a, *b;
    uint8_t *out;
    size_t len;
} xor_job_t;

static void *xor_worker(void *arg) {
    xor_job_t *j = (xor_job_t *)arg;
    for (size_t i = 0; i < j->len; i++) j->out[i] = (uint8_t)(j->a[i] ^ j->b[i]);
    return NULL;
}

void ot_xor(const uint8_t *data, const uint8_t *keystream, uint8_t *out,
            size_t len, int nthreads) {
    nthreads = clamp_threads(nthreads, len ? len : 1);
    xor_job_t jobs[OT_MAX_THREADS];
    pthread_t tids[OT_MAX_THREADS];
    size_t per = len / (size_t)nthreads, off = 0;
    for (int t = 0; t < nthreads; t++) {
        size_t take = per + ((size_t)t < len % (size_t)nthreads ? 1 : 0);
        jobs[t] = (xor_job_t){data + off, keystream + off, out + off, take};
        off += take;
    }
    int spawned[OT_MAX_THREADS] = {0};
    for (int t = 1; t < nthreads; t++)
        spawned[t] = pthread_create(&tids[t], NULL, xor_worker, &jobs[t]) == 0;
    xor_worker(&jobs[0]);
    for (int t = 1; t < nthreads; t++) {
        if (spawned[t])
            pthread_join(tids[t], NULL);
        else
            xor_worker(&jobs[t]);
    }
}
