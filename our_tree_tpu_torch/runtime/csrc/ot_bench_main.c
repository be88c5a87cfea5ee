/* ot_bench: the reference harness shape (test.c / aes-modes/test.c), one
 * executable, two dispatch targets:
 *
 *   --backend=c    sweep the native runtime in-process (pthread workers,
 *                  gettimeofday-style timing, CSV rows on stdout: the
 *                  modern form of reference aes-modes/test.c:353-446).
 *   --backend=gpu  embed CPython and hand the same sweep arguments to
 *                  our_tree_tpu_torch.harness.bench with --backend gpu
 *                  (and --device, default cuda): the thin shim by which
 *                  the C harness drives the card.
 *
 * CSV format matches the reference results corpus:
 *   <name>, <bytes>, <threads>, t1, ..., tN,
 *
 * Build: runtime/native.py:ot_bench_path() (links libpython, with
 * -DOT_WITH_PYTHON, where `python3-config --embed` answers). The embedded
 * interpreter takes sys.path from the libpython it links: hand it the repo
 * and the site-packages through PYTHONPATH.
 */
#include "ot_crypt.h"

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/time.h>

#define MAX_LIST 16

static long long now_us(void) {
    struct timeval tv;
    gettimeofday(&tv, NULL);
    return (long long)tv.tv_sec * 1000000 + tv.tv_usec;
}

/* Exact token match in a comma-separated mode list: plain strstr would
 * make --modes=ecb-dec also enable the "ecb" sweep. */
static int has_mode(const char *modes, const char *tok) {
    size_t n = strlen(tok);
    const char *p = modes;
    while ((p = strstr(p, tok)) != NULL) {
        int left_ok = (p == modes) || (p[-1] == ',');
        int right_ok = (p[n] == '\0') || (p[n] == ',');
        if (left_ok && right_ok) return 1;
        p += 1;
    }
    return 0;
}

static int parse_list(const char *s, long long *out, int cap) {
    int n = 0;
    while (*s && n < cap) {
        out[n++] = atoll(s);
        const char *c = strchr(s, ',');
        if (!c) break;
        s = c + 1;
    }
    return n;
}

/* xorshift PRNG, seeded 1337 like the reference (test.c:131). */
static unsigned long long rng_state = 1337;
static unsigned char rng_byte(void) {
    rng_state ^= rng_state << 13;
    rng_state ^= rng_state >> 7;
    rng_state ^= rng_state << 17;
    return (unsigned char)rng_state;
}

static void fill_random(unsigned char *p, size_t n) {
    for (size_t i = 0; i < n; i++) p[i] = rng_byte();
}

static void sweep_aes(const char *mode, size_t size, const long long *threads,
                      int nthreads_cnt, int iters, int keybits) {
    unsigned char *msg = malloc(size), *out = malloc(size);
    unsigned char key[32], nonce[16];
    if (!msg || !out) { fprintf(stderr, "alloc failed\n"); exit(1); }
    fill_random(msg, size);
    for (int t = 0; t < nthreads_cnt; t++) {
        int nt = (int)threads[t];
        printf("C AES-%d %s, %zu, %d, ", keybits, mode, size, nt);
        for (int it = 0; it < iters; it++) {
            fill_random(key, sizeof key);       /* per-iter rekey, test.c:301 */
            ot_aes_ctx ctx;
            if (ot_aes_setkey(&ctx, key, keybits) != 0) {
                fprintf(stderr, "invalid --keybits=%d\n", keybits);
                exit(1);
            }
            memset(nonce, 0xA5, sizeof nonce);
            long long t0 = now_us();
            if (strcmp(mode, "ECB") == 0)
                ot_aes_ecb(&ctx, 1, msg, out, size / 16, nt);
            else if (strcmp(mode, "ECB-DEC") == 0)
                /* Inverse cipher (decrypt rows measure the inverse round
                 * structure; throughput is data-independent, so decrypting
                 * random bytes is a faithful measurement). */
                ot_aes_ecb(&ctx, 0, msg, out, size / 16, nt);
            else if (strcmp(mode, "CBC-DEC") == 0)
                /* Chunk-parallel, unlike CBC encrypt (each chunk's chain
                 * needs only ciphertext — ot_crypt.h). */
                ot_aes_cbc_decrypt(&ctx, nonce, msg, out, size / 16, nt);
            else
                ot_aes_ctr(&ctx, nonce, msg, out, size, nt);
            printf("%lld, ", now_us() - t0);
        }
        printf("\n");
    }
    free(msg);
    free(out);
}

static void sweep_rc4(size_t size, const long long *threads, int nthreads_cnt,
                      int iters) {
    unsigned char *msg = malloc(size), *out = malloc(size);
    unsigned char *ks = malloc(size);
    unsigned char key[16];
    if (!msg || !out || !ks) { fprintf(stderr, "alloc failed\n"); exit(1); }
    fill_random(msg, size);
    for (int t = 0; t < nthreads_cnt; t++) {
        int nt = (int)threads[t];
        printf("RC4, %zu, %d, \n", size, nt);
        fill_random(key, sizeof key);
        ot_arc4_ctx ctx;
        long long t0 = now_us();
        ot_arc4_setup(&ctx, key, sizeof key);
        ot_arc4_prep(&ctx, ks, size);           /* sequential phase, timed */
        printf("Generated a new key in %lld, \n", now_us() - t0);
        for (int it = 0; it < iters; it++) {
            t0 = now_us();
            ot_xor(msg, ks, out, size, nt);      /* parallel phase */
            printf("%lld, ", now_us() - t0);
        }
        printf("\n");
    }
    free(msg); free(out); free(ks);
}

#ifdef OT_WITH_PYTHON
#include <Python.h>

static int dispatch_gpu(const char *sizes, const char *threads, int iters,
                        int keybits, const char *modes, const char *device) {
    /* The thin shim: same sweep arguments, executed on the card. */
    char code[1024];
    snprintf(code, sizeof code,
             "import sys\n"
             "from our_tree_tpu_torch.harness.bench import main\n"
             "sys.exit(main(['--backend','gpu','--device','%s',"
             "'--sizes-mb','%s','--workers','%s',"
             "'--iters','%d','--keybits','%d','--modes','%s']))\n",
             device, sizes, threads, iters, keybits, modes);
    Py_Initialize();
    int rc = PyRun_SimpleString(code);
    if (Py_FinalizeEx() < 0) rc = 1;
    return rc == 0 ? 0 : 1;
}
#endif

int main(int argc, char **argv) {
    const char *backend = "c", *sizes_s = "1,10,100,1000";
    /* Default mode list matches harness/bench.py's default, so the gpu
     * shim forwards the same sweep either way it is invoked. */
    const char *threads_s = "1,2,4,8", *modes = "ecb,ecb-dec,ctr,cbc-dec,rc4";
    const char *device = "cuda";
    int iters = 10, keybits = 256;
    for (int i = 1; i < argc; i++) {
        if (strncmp(argv[i], "--backend=", 10) == 0) backend = argv[i] + 10;
        else if (strncmp(argv[i], "--sizes=", 8) == 0) sizes_s = argv[i] + 8;
        else if (strncmp(argv[i], "--threads=", 10) == 0) threads_s = argv[i] + 10;
        else if (strncmp(argv[i], "--iters=", 8) == 0) iters = atoi(argv[i] + 8);
        else if (strncmp(argv[i], "--keybits=", 10) == 0) keybits = atoi(argv[i] + 10);
        else if (strncmp(argv[i], "--modes=", 8) == 0) modes = argv[i] + 8;
        else if (strncmp(argv[i], "--device=", 9) == 0) device = argv[i] + 9;
        else {
            fprintf(stderr,
                    "usage: ot_bench [--backend=c|gpu] [--sizes=MB,..]\n"
                    "                [--threads=N,..] [--iters=N]\n"
                    "                [--keybits=128|192|256]\n"
                    "                [--modes=ecb,ecb-dec,ctr,cbc-dec,rc4]\n"
                    "                [--device=cuda|cpu]  (gpu backend)\n");
            return 1;
        }
    }

    if (strcmp(backend, "gpu") == 0) {
#ifdef OT_WITH_PYTHON
        return dispatch_gpu(sizes_s, threads_s, iters, keybits, modes, device);
#else
        fprintf(stderr, "ot_bench built without python embedding "
                        "(python3-config --embed did not answer)\n");
        return 1;
#endif
    }
    if (strcmp(backend, "c") != 0) {
        fprintf(stderr, "unknown --backend=%s (expected c or gpu)\n", backend);
        return 1;
    }

    long long sizes[MAX_LIST], threads[MAX_LIST];
    int ns = parse_list(sizes_s, sizes, MAX_LIST);
    int nt = parse_list(threads_s, threads, MAX_LIST);
    int do_ecb = has_mode(modes, "ecb");
    int do_ecbd = has_mode(modes, "ecb-dec");
    int do_cbcd = has_mode(modes, "cbc-dec");
    int do_ctr = has_mode(modes, "ctr");
    int do_rc4 = has_mode(modes, "rc4");
    for (int s = 0; s < ns; s++) {
        size_t bytes = (size_t)sizes[s] << 20;
        if (do_ecb) sweep_aes("ECB", bytes, threads, nt, iters, keybits);
        if (do_ecbd) sweep_aes("ECB-DEC", bytes, threads, nt, iters, keybits);
        if (do_ctr) sweep_aes("CTR", bytes, threads, nt, iters, keybits);
        if (do_cbcd) sweep_aes("CBC-DEC", bytes, threads, nt, iters, keybits);
        if (do_rc4) sweep_rc4(bytes, threads, nt, iters);
    }
    return 0;
}
