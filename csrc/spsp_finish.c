/* Native host finisher: the reference-exact k-mer store, greedy
 * super-k-mer reconstruction and bucket serialization
 * (reference SubSampler.cpp:243-302, 456-504, 512-620).
 *
 * The Python oracle (oracle/subsampler.py) is the executable spec;
 * this file replicates its semantics byte-for-byte so the pipeline's
 * host tail runs at C speed:
 *   - per-span intake: orientation, minimizer-string occurrences
 *     (kmerstr.find semantics incl. spurious textual matches),
 *     rolling 128-bit k-mers, insertion-ordered dedup with uint8
 *     count wrap;
 *   - serialization: ascending-minimizer buckets, find_first /
 *     find_next greedy walk with the reference's ATCG probe order and
 *     n_start reset quirk, maximal/plaintext split, strCompressor
 *     packing with the mod-prefix layout (garbage bits pinned to 0).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    uint64_t hi, lo;      /* 2k-bit k-mer, hi = bits >= 64 */
    uint8_t count;        /* uint8 wrap, SubSampler.h:24 */
    uint8_t pos_min;
    uint8_t seen;
} Entry;

typedef struct {
    uint32_t minimizer;
    int32_t len, cap;
    int32_t *idx;         /* entry indices in first-insertion order */
    int32_t resume;       /* first possibly-unseen slot (monotonic) */
} Bucket;

typedef struct {
    int k, m, abundance;
    uint64_t mask_hi;     /* mask for hi limb (2k-64 bits; 0 if k<=32) */
    int khi;              /* 1 if 2k > 64 */

    Entry *entries;
    int32_t n_entries, cap_entries;

    /* global open-addressing map: (minimizer, hi, lo) -> entry index */
    int64_t *slots;       /* -1 empty, else entry idx */
    uint32_t *slot_min;
    int64_t n_slots_mask; /* power-of-two - 1 */
    int64_t n_used;

    Bucket *buckets;
    int32_t n_buckets, cap_buckets;
    /* bucket open addressing: minimizer -> bucket index */
    int32_t *bslots;
    int64_t bslots_mask;

    /* reconstruction counters (oracle names) */
    int64_t seen_kmers, seen_skmers, seen_max_skmers, seen_unique,
        total_kmer_recon;
} Store;

static const uint8_t NUC2INT[256] = {
    ['A'] = 0, ['C'] = 1, ['G'] = 3, ['T'] = 2,
    ['a'] = 0, ['c'] = 1, ['g'] = 3, ['t'] = 2,
};
static const char INT2NUC[4] = {'A', 'C', 'T', 'G'};
static const uint8_t PROBE[4] = {0, 2, 1, 3}; /* "ATCG" as codes */

static uint64_t mix64(uint64_t x)
{
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
}

static uint64_t key_hash(uint32_t mini, uint64_t hi, uint64_t lo)
{
    return mix64(hi * 0x9e3779b97f4a7c15ULL ^ mix64(lo) ^ mini);
}

static void map_grow(Store *s)
{
    int64_t nn = (s->n_slots_mask + 1) * 2;
    int64_t *ns = malloc(nn * sizeof(int64_t));
    uint32_t *nm = malloc(nn * sizeof(uint32_t));
    memset(ns, 0xFF, nn * sizeof(int64_t));
    for (int64_t i = 0; i <= s->n_slots_mask; i++) {
        int64_t e = s->slots[i];
        if (e < 0)
            continue;
        uint64_t h = key_hash(s->slot_min[i], s->entries[e].hi,
                              s->entries[e].lo) & (nn - 1);
        while (ns[h] >= 0)
            h = (h + 1) & (nn - 1);
        ns[h] = e;
        nm[h] = s->slot_min[i];
    }
    free(s->slots);
    free(s->slot_min);
    s->slots = ns;
    s->slot_min = nm;
    s->n_slots_mask = nn - 1;
}

/* find or insert; returns entry index, sets *fresh */
static int32_t map_upsert(Store *s, uint32_t mini, uint64_t hi,
                          uint64_t lo, int *fresh)
{
    if (s->n_used * 10 >= (s->n_slots_mask + 1) * 7)
        map_grow(s);
    uint64_t h = key_hash(mini, hi, lo) & s->n_slots_mask;
    for (;;) {
        int64_t e = s->slots[h];
        if (e < 0)
            break;
        if (s->slot_min[h] == mini && s->entries[e].hi == hi
            && s->entries[e].lo == lo) {
            *fresh = 0;
            return (int32_t)e;
        }
        h = (h + 1) & s->n_slots_mask;
    }
    if (s->n_entries == s->cap_entries) {
        s->cap_entries *= 2;
        s->entries = realloc(s->entries,
                             s->cap_entries * sizeof(Entry));
    }
    int32_t e = s->n_entries++;
    s->slots[h] = e;
    s->slot_min[h] = mini;
    s->n_used++;
    *fresh = 1;
    return e;
}

/* lookup only; -1 if absent */
static int32_t map_find(Store *s, uint32_t mini, uint64_t hi,
                        uint64_t lo)
{
    uint64_t h = key_hash(mini, hi, lo) & s->n_slots_mask;
    for (;;) {
        int64_t e = s->slots[h];
        if (e < 0)
            return -1;
        if (s->slot_min[h] == mini && s->entries[e].hi == hi
            && s->entries[e].lo == lo)
            return (int32_t)e;
        h = (h + 1) & s->n_slots_mask;
    }
}

static Bucket *bucket_get(Store *s, uint32_t mini)
{
    uint64_t h = mix64(mini) & s->bslots_mask;
    for (;;) {
        int32_t b = s->bslots[h];
        if (b < 0)
            break;
        if (s->buckets[b].minimizer == mini)
            return &s->buckets[b];
        h = (h + 1) & s->bslots_mask;
    }
    if (s->n_buckets == s->cap_buckets) {
        s->cap_buckets *= 2;
        s->buckets = realloc(s->buckets,
                             s->cap_buckets * sizeof(Bucket));
    }
    if ((int64_t)s->n_buckets * 10 >= (s->bslots_mask + 1) * 7) {
        int64_t nn = (s->bslots_mask + 1) * 2;
        int32_t *nb = malloc(nn * sizeof(int32_t));
        memset(nb, 0xFF, nn * sizeof(int32_t));
        for (int32_t i = 0; i < s->n_buckets; i++) {
            uint64_t hh = mix64(s->buckets[i].minimizer) & (nn - 1);
            while (nb[hh] >= 0)
                hh = (hh + 1) & (nn - 1);
            nb[hh] = i;
        }
        free(s->bslots);
        s->bslots = nb;
        s->bslots_mask = nn - 1;
        h = mix64(mini) & s->bslots_mask;
        while (s->bslots[h] >= 0)
            h = (h + 1) & s->bslots_mask;
    }
    int32_t b = s->n_buckets++;
    s->bslots[h] = b;
    Bucket *bk = &s->buckets[b];
    bk->minimizer = mini;
    bk->len = 0;
    bk->cap = 8;
    bk->idx = malloc(8 * sizeof(int32_t));
    bk->resume = 0;
    return bk;
}

void *spsp_finish_new(int k, int m, int abundance)
{
    Store *s = calloc(1, sizeof(Store));
    s->k = k;
    s->m = m;
    s->abundance = abundance;
    s->khi = 2 * k > 64;
    s->mask_hi = s->khi ? ((1ULL << (2 * k - 64)) - 1) : 0;
    s->cap_entries = 1 << 12;
    s->entries = malloc(s->cap_entries * sizeof(Entry));
    s->n_slots_mask = (1 << 13) - 1;
    s->slots = malloc((s->n_slots_mask + 1) * sizeof(int64_t));
    s->slot_min = malloc((s->n_slots_mask + 1) * sizeof(uint32_t));
    memset(s->slots, 0xFF, (s->n_slots_mask + 1) * sizeof(int64_t));
    s->cap_buckets = 1 << 10;
    s->buckets = malloc(s->cap_buckets * sizeof(Bucket));
    s->bslots_mask = (1 << 11) - 1;
    s->bslots = malloc((s->bslots_mask + 1) * sizeof(int32_t));
    memset(s->bslots, 0xFF, (s->bslots_mask + 1) * sizeof(int32_t));
    return s;
}

void spsp_finish_free(void *h)
{
    Store *s = h;
    for (int32_t i = 0; i < s->n_buckets; i++)
        free(s->buckets[i].idx);
    free(s->buckets);
    free(s->bslots);
    free(s->entries);
    free(s->slots);
    free(s->slot_min);
    free(s);
}

/* handle_superkmer for a batch of spans (SubSampler.cpp:243-302).
 * ref: ACGT bytes; spans are [last[i], pos[i]+k) with minimizer val[i]
 * and strand rev[i]. */
void spsp_finish_spans(void *hd, const char *ref, int64_t ref_len,
                       int64_t n, const int64_t *pos,
                       const int64_t *last, const uint32_t *val,
                       const uint8_t *rev)
{
    Store *s = hd;
    int k = s->k, m = s->m;
    uint8_t codes[256];
    uint8_t mcodes[16];

    for (int64_t sp = 0; sp < n; sp++) {
        int64_t a = last[sp], b = pos[sp] + k;
        int len = (int)(b - a);
        if (rev[sp]) {
            for (int i = 0; i < len; i++)
                codes[i] = NUC2INT[(uint8_t)ref[b - 1 - i]] ^ 2;
        } else {
            for (int i = 0; i < len; i++)
                codes[i] = NUC2INT[(uint8_t)ref[a + i]];
        }
        uint32_t v = val[sp];
        for (int j = m - 1; j >= 0; j--) {
            mcodes[j] = v & 3;
            v >>= 2;
        }
        Bucket *bk = bucket_get(s, val[sp]);

        /* rolling k-mer limbs + first-occurrence search per window */
        uint64_t hi = 0, lo = 0;
        for (int i = 0; i < k - 1; i++) {
            hi = s->khi ? (((hi << 2) | (lo >> 62)) & s->mask_hi) : 0;
            lo = (lo << 2) | codes[i];
        }
        if (!s->khi)
            lo &= (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
        int nk = len - k + 1;
        int occ = -1; /* current candidate occurrence */
        for (int i = 0; i < nk; i++) {
            hi = s->khi ? (((hi << 2) | (lo >> 62)) & s->mask_hi) : 0;
            lo = (lo << 2) | codes[i + k - 1];
            if (!s->khi)
                lo &= (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
            if (occ < i) {
                for (occ = i; occ <= len - m; occ++) {
                    if (!memcmp(codes + occ, mcodes, m))
                        break;
                }
            }
            int fresh;
            int32_t e = map_upsert(s, val[sp], hi, lo, &fresh);
            if (fresh) {
                s->entries[e].hi = hi;
                s->entries[e].lo = lo;
                s->entries[e].count = 1;
                s->entries[e].pos_min = (uint8_t)(occ - i);
                s->entries[e].seen = 0;
                if (bk->len == bk->cap) {
                    bk->cap *= 2;
                    bk->idx = realloc(bk->idx,
                                      bk->cap * sizeof(int32_t));
                }
                bk->idx[bk->len++] = e;
            } else {
                s->entries[e].count++; /* uint8 wrap */
            }
        }
    }
}

static int cmp_u32(const void *a, const void *b)
{
    uint32_t x = *(const uint32_t *)a, y = *(const uint32_t *)b;
    return x < y ? -1 : (x > y ? 1 : 0);
}

typedef struct {
    char *p;
    size_t len, cap;
} Buf;

static void buf_put(Buf *o, const void *d, size_t n)
{
    if (o->len + n > o->cap) {
        while (o->len + n > o->cap)
            o->cap *= 2;
        o->p = realloc(o->p, o->cap);
    }
    memcpy(o->p + o->len, d, n);
    o->len += n;
}

/* find_first (SubSampler.cpp:604-620) */
static int32_t find_first(Store *s, Bucket *bk)
{
    for (; bk->resume < bk->len; bk->resume++) {
        Entry *e = &s->entries[bk->idx[bk->resume]];
        if (!e->seen && e->count >= s->abundance) {
            s->total_kmer_recon += e->count;
            s->seen_unique++;
            e->seen = 1;
            return bk->idx[bk->resume];
        }
        if (!e->seen)
            break; /* unseen but below abundance: resume stops here */
    }
    /* continue the scan without advancing resume past unseen entries */
    for (int32_t i = bk->resume; i < bk->len; i++) {
        Entry *e = &s->entries[bk->idx[i]];
        if (!e->seen && e->count >= s->abundance) {
            s->total_kmer_recon += e->count;
            s->seen_unique++;
            e->seen = 1;
            return bk->idx[i];
        }
    }
    return -1;
}

/* find_next (SubSampler.cpp:566-602); returns entry or -1 */
static int32_t find_next(Store *s, uint32_t mini, uint64_t hi,
                         uint64_t lo, int left, uint64_t *nhi,
                         uint64_t *nlo)
{
    int k = s->k;
    for (int pi = 0; pi < 4; pi++) {
        uint64_t c = PROBE[pi];
        uint64_t thi, tlo;
        if (left) {
            if (s->khi) {
                thi = (hi >> 2) | (c << (2 * k - 64 - 2));
                tlo = (lo >> 2) | (hi << 62);
            } else {
                thi = 0;
                tlo = (lo >> 2)
                    | (c << (2 * k - 2 >= 64 ? 0 : 2 * k - 2));
            }
        } else {
            if (s->khi) {
                thi = ((hi << 2) | (lo >> 62)) & s->mask_hi;
                tlo = (lo << 2) | c;
            } else {
                thi = 0;
                tlo = ((lo << 2) | c)
                    & ((k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL);
            }
        }
        int32_t e = map_find(s, mini, thi, tlo);
        if (e >= 0 && !s->entries[e].seen
            && s->entries[e].count >= s->abundance) {
            s->entries[e].seen = 1;
            s->seen_unique++;
            s->total_kmer_recon += s->entries[e].count;
            *nhi = thi;
            *nlo = tlo;
            return e;
        }
    }
    return -1;
}

static void kmer_to_chars(Store *s, uint64_t hi, uint64_t lo, char *out)
{
    int k = s->k;
    for (int i = k - 1; i >= 0; i--) {
        out[i] = INT2NUC[lo & 3];
        lo = (lo >> 2) | (hi << 62);
        hi >>= 2;
    }
}

/* serialize all buckets (SubSampler.cpp:456-504, minus the header
 * line); returns malloc'd buffer via *out. counters[0..5] get the
 * reconstruction stats. */
int64_t spsp_finish_serialize(void *hd, char **out, int64_t *counters)
{
    Store *s = hd;
    int k = s->k, m = s->m;
    int maxsk = 2 * k - m;
    Buf o = {malloc(1 << 20), 0, 1 << 20};

    uint32_t *minis = malloc(s->n_buckets * sizeof(uint32_t));
    for (int32_t i = 0; i < s->n_buckets; i++)
        minis[i] = s->buckets[i].minimizer;
    qsort(minis, s->n_buckets, sizeof(uint32_t), cmp_u32);

    char minstr[16];
    char skmer[256];
    Buf blob = {malloc(1 << 16), 0, 1 << 16};
    Buf plain = {malloc(1 << 16), 0, 1 << 16};

    for (int32_t bi = 0; bi < s->n_buckets; bi++) {
        Bucket *bk = bucket_get(s, minis[bi]);
        uint32_t v = bk->minimizer;
        for (int j = m - 1; j >= 0; j--) {
            minstr[j] = INT2NUC[v & 3];
            v >>= 2;
        }
        s->seen_kmers += bk->len;
        blob.len = 0;
        plain.len = 0;

        int64_t i = 0;
        while (i <= bk->len) {
            int32_t e0 = find_first(s, bk);
            if (e0 < 0)
                break;
            Entry *e = &s->entries[e0];
            uint64_t shi = e->hi, slo = e->lo;
            kmer_to_chars(s, shi, slo, skmer);
            int sklen = k;
            int n_left = (k - m) - e->pos_min;
            int n_right = e->pos_min;
            uint64_t chi = shi, clo = slo;
            uint64_t nhi, nlo;
            while (sklen != maxsk) {
                if (n_left != 0) {
                    int32_t ne = find_next(s, bk->minimizer, chi, clo,
                                           1, &nhi, &nlo);
                    n_left--;
                    if (ne >= 0) {
                        memmove(skmer + 1, skmer, sklen);
                        /* leftmost char of the new k-mer */
                        uint64_t top = s->khi
                            ? (nhi >> (2 * k - 64 - 2)) & 3
                            : (nlo >> (2 * k - 2)) & 3;
                        skmer[0] = INT2NUC[top];
                        sklen++;
                        chi = nhi;
                        clo = nlo;
                    } else {
                        n_left = 0;
                    }
                    if (n_left == 0) {
                        chi = shi;
                        clo = slo;
                    }
                } else if (n_right != 0) {
                    int32_t ne = find_next(s, bk->minimizer, chi, clo,
                                           0, &nhi, &nlo);
                    n_right--;
                    if (ne >= 0) {
                        skmer[sklen++] = INT2NUC[nlo & 3];
                        chi = nhi;
                        clo = nlo;
                    } else {
                        break;
                    }
                } else {
                    break;
                }
            }
            s->seen_skmers++;
            if (sklen == maxsk) {
                i += k - m + 1;
                s->seen_max_skmers++;
                buf_put(&blob, skmer, k - m);
                buf_put(&blob, skmer + k, k - m);
            } else {
                i += sklen - k + 1;
                /* first occurrence of minstr in skmer */
                int p = 0;
                for (; p + m <= sklen; p++)
                    if (!memcmp(skmer + p, minstr, m))
                        break;
                buf_put(&plain, skmer, p);
                buf_put(&plain, "\n", 1);
                buf_put(&plain, skmer + p + m, sklen - p - m);
                buf_put(&plain, "\n", 1);
            }
        }

        /* bucket record: minstr, u32 len, strCompressor blob, plains */
        buf_put(&o, minstr, m);
        /* strCompressor (utils.cpp:48-68): [mod][full bytes][tail] */
        size_t nn = blob.len;
        uint32_t mod = (uint32_t)(nn % 4);
        size_t nfull = nn / 4;
        uint32_t clen = nn ? (uint32_t)(1 + nfull + (mod ? 1 : 0)) : 0;
        buf_put(&o, &clen, 4);
        if (nn) {
            uint8_t mb = (uint8_t)mod;
            buf_put(&o, &mb, 1);
            for (size_t g = 0; g < nfull; g++) {
                const char *q = blob.p + 4 * g;
                uint8_t pb = (uint8_t)((NUC2INT[(uint8_t)q[0]] << 6)
                                       | (NUC2INT[(uint8_t)q[1]] << 4)
                                       | (NUC2INT[(uint8_t)q[2]] << 2)
                                       | NUC2INT[(uint8_t)q[3]]);
                buf_put(&o, &pb, 1);
            }
            if (mod) {
                uint8_t c = 0;
                for (size_t t = 4 * nfull; t < nn; t++)
                    c = (uint8_t)(((c | NUC2INT[(uint8_t)blob.p[t]])
                                   << 2) & 0xFF);
                buf_put(&o, &c, 1);
            }
        }
        buf_put(&o, plain.p, plain.len);
        buf_put(&o, "\n\n", 2);
    }
    free(minis);
    free(blob.p);
    free(plain.p);

    counters[0] = s->seen_kmers;
    counters[1] = s->seen_skmers;
    counters[2] = s->seen_max_skmers;
    counters[3] = s->seen_unique;
    counters[4] = s->total_kmer_recon;
    counters[5] = s->n_buckets;
    *out = o.p;
    return (int64_t)o.len;
}

void spsp_finish_release(char *p) { free(p); }

/* Batch span ingest: one ctypes call feeds a contiguous RUN of
 * records (record order preserved -- the store's first-insertion
 * order is part of the byte-exact serialization contract, reference
 * SubSampler.h:62).  Event arrays are record-major slices of a
 * batched resolve fetch; per-record tails (the reference's
 * end-of-sequence flush, SubSampler.cpp:441-454) are synthesized
 * here: tail_last[r] < 0 means no selected tail. */
void spsp_finish_spans_batch(void *hd, const uint8_t *ref_pool,
                             const int64_t *ref_offs,
                             const int64_t *ref_lens, int64_t n_rec,
                             const int64_t *pos, const int64_t *last,
                             const uint32_t *val, const uint8_t *rev,
                             const int64_t *span_offs,
                             const int64_t *tail_last,
                             const uint32_t *tail_val,
                             const uint8_t *tail_rev)
{
    Store *s = hd;
    for (int64_t r = 0; r < n_rec; r++) {
        const char *ref = (const char *)(ref_pool + ref_offs[r]);
        int64_t a = span_offs[r], b = span_offs[r + 1];
        if (b > a)
            spsp_finish_spans(hd, ref, ref_lens[r], b - a, pos + a,
                              last + a, val + a, rev + a);
        if (tail_last[r] >= 0) {
            int64_t tp = ref_lens[r] - s->k;
            int64_t tl = tail_last[r];
            spsp_finish_spans(hd, ref, ref_lens[r], 1, &tp, &tl,
                              tail_val + r, tail_rev + r);
        }
    }
}
