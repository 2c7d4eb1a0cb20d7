// Native host kernels for gmres_tpu (ctypes ABI).
//
// These are the setup-time, inherently sequential pieces that stay on the
// host (SURVEY.md §7): ILU(0) factorization (the
// reference's ilu0_impl role, kernels_mkl.cpp:416-496 — with diagonal
// positions computed correctly, fixing the reference's unpopulated
// diag_inds defect), triangular dependency-level counts (the analysis
// phase of cusparse csrsv2, kernels_cuda.cpp:27-58), exact sequential
// triangular solves (host verification oracle), and a fast MatrixMarket
// coordinate-line parser (the mmio.c role).
//
// Build: gmres_tpu/native.py compiles this file on first use
// (g++ -O3 -fPIC -shared -std=c++17).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <functional>

extern "C" {

// Sequential IKJ ILU(0) on a CSR pattern with sorted rows and a full
// diagonal.  vals is updated in place (factor values); diag_pos receives
// the index of each row's diagonal entry.  Pivots in rows 1..n-1 with
// magnitude below boost_alpha are clamped to +/-boost_alpha (row 0 is not
// boosted, matching the reference).  Returns 0 on success, -(i+1) if row i
// has no entry with column >= i.
int ilu0_factorize(int64_t n,
                   const int32_t* row_ptr,
                   const int32_t* col_idx,
                   double* vals,
                   int64_t* diag_pos,
                   double boost_alpha) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t lo = row_ptr[i], hi = row_ptr[i + 1];
        // rows are sorted by column: binary search for the first col >= i
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            if (col_idx[mid] < i) lo = mid + 1; else hi = mid;
        }
        if (lo >= row_ptr[i + 1]) return (int)(-(i + 1));
        diag_pos[i] = lo;
    }

    for (int64_t i = 1; i < n; ++i) {
        const int64_t row_start = row_ptr[i];
        const int64_t row_end = row_ptr[i + 1];

        for (int64_t k_ind = row_start; col_idx[k_ind] < i; ++k_ind) {
            const int32_t k = col_idx[k_ind];
            const double factor = vals[k_ind] / vals[diag_pos[k]];
            vals[k_ind] = factor;

            int64_t prev_ind = diag_pos[k] + 1;
            const int64_t prev_end = row_ptr[k + 1];
            int64_t j_ind = k_ind + 1;
            while (j_ind < row_end && prev_ind < prev_end) {
                const int32_t cp = col_idx[prev_ind];
                const int32_t cj = col_idx[j_ind];
                if (cp < cj) {
                    ++prev_ind;
                } else if (cp > cj) {
                    ++j_ind;
                } else {
                    vals[j_ind] -= factor * vals[prev_ind];
                    ++prev_ind;
                    ++j_ind;
                }
            }
        }

        double& dv = vals[diag_pos[i]];
        if (dv >= 0) {
            if (dv < boost_alpha) dv = boost_alpha;
        } else {
            if (dv > -boost_alpha) dv = -boost_alpha;
        }
    }
    return 0;
}

// Dependency-level counts (nilpotency indices) of the strict-lower and
// strict-upper parts.  lev_l/lev_u are scratch of size n; the function
// returns counts via out_l/out_u (= max level + 1).
void tri_level_counts(int64_t n,
                      const int32_t* row_ptr,
                      const int32_t* col_idx,
                      const int64_t* diag_pos,
                      int64_t* lev_l,
                      int64_t* lev_u,
                      int64_t* out_l,
                      int64_t* out_u) {
    int64_t max_l = 0, max_u = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t lv = 0;
        for (int64_t j = row_ptr[i]; j < diag_pos[i]; ++j) {
            const int64_t d = lev_l[col_idx[j]];
            if (d + 1 > lv) lv = d + 1;
        }
        lev_l[i] = lv;
        if (lv > max_l) max_l = lv;
    }
    for (int64_t i = n - 1; i >= 0; --i) {
        int64_t lv = 0;
        for (int64_t j = diag_pos[i] + 1; j < row_ptr[i + 1]; ++j) {
            const int64_t d = lev_u[col_idx[j]];
            if (d + 1 > lv) lv = d + 1;
        }
        lev_u[i] = lv;
        if (lv > max_u) max_u = lv;
    }
    *out_l = max_l + 1;
    *out_u = max_u + 1;
}

// Exact sequential triangular solves on the combined ILU factor:
// unit-lower forward substitution, then upper backward substitution
// (the reference's ilusv, kernels_mkl.cpp:355-383).  x is in-out.
void ilu_trisolve(int64_t n,
                  const int32_t* row_ptr,
                  const int32_t* col_idx,
                  const double* vals,
                  const int64_t* diag_pos,
                  double* x) {
    for (int64_t i = 0; i < n; ++i) {
        double sum = x[i];
        for (int64_t j = row_ptr[i]; j < diag_pos[i]; ++j)
            sum -= vals[j] * x[col_idx[j]];
        x[i] = sum;  // unit diagonal
    }
    for (int64_t i = n - 1; i >= 0; --i) {
        double sum = x[i];
        for (int64_t j = diag_pos[i] + 1; j < row_ptr[i + 1]; ++j)
            sum -= vals[j] * x[col_idx[j]];
        x[i] = sum / vals[diag_pos[i]];
    }
}

// Fast MatrixMarket coordinate-line parser: reads nnz whitespace-separated
// (row col [value]) triples from buf.  1-based indices converted to
// 0-based.  pattern != 0 means no value column (values set to 1.0).
// Returns the number of entries parsed (== nnz on success).
int64_t parse_coord(const char* buf,
                    int64_t len,
                    int64_t nnz,
                    int32_t* I,
                    int32_t* J,
                    double* V,
                    int pattern) {
    const char* p = buf;
    const char* end = buf + len;
    int64_t count = 0;
    while (count < nnz && p < end) {
        char* next;
        // skip comment lines
        while (p < end && (*p == '%' || *p == '\n' || *p == '\r')) {
            if (*p == '%') {
                while (p < end && *p != '\n') ++p;
            } else {
                ++p;
            }
        }
        if (p >= end) break;
        long row = strtol(p, &next, 10);
        if (next == p) break;
        p = next;
        long col = strtol(p, &next, 10);
        if (next == p) break;
        p = next;
        double val = 1.0;
        if (!pattern) {
            val = strtod(p, &next);
            if (next == p) break;
            p = next;
        }
        I[count] = (int32_t)(row - 1);
        J[count] = (int32_t)(col - 1);
        V[count] = val;
        ++count;
    }
    return count;
}

// ---------------------------------------------------------------------------
// SELL packer fast path (the hot loops of ops/sell.py:sell_from_csr).
//
// The numpy packer streams ~15 nnz-scale array passes (group detection,
// classification gathers, ufunc.at scatters, dtype splits) over a single
// throttled host core; these two functions replace them with two streaming
// passes.  Semantics are kept bit-identical to the numpy path (verified by
// tests/test_sell_native.py): same rb/sb grouping, same dense
// classification, same chunk layout INCLUDING the G-batch dummy padding
// positions numpy produces via its stable argsort (G is a caller
// parameter; G < 1 in the PLAN pass means auto-pick from the per-block
// chunk counts, reported via out_counts[4] — the FILL pass must receive
// the resolved G), so the fill pass writes values directly into their
// final (chunk, slot, row) cells.
//
// Layout contract (ops/sell.py SELLMatrix):
//   slab = row / C;  bucket = col / W;  sb = slab * n_buckets + bucket
//   rb group = maximal run of entries with equal (row, bucket) (requires
//   CSR entries sorted by (row, col); detected and refused otherwise)
//   dense pair: sb total count >= dense_min_cnt (capped at max_dense_blocks
//   largest);  ELL pair: ceil(max rb count / K) chunk layers
//   final chunk order: slabs ascending; within a block, the block's dummy
//   chunks sit after the reals of the block's FIRST slab (numpy appends
//   dummies with slab = block*SLABS_PER_BLOCK and stable-sorts).

static const int64_t SELL_C = 128;             // rows per slab
static const int64_t SELL_SLABS_PER_BLOCK = 8;
static const int64_t SELL_G_BATCH = 4;  // default when the G param is < 1

// Phase 1: scan + group + classify.  Outputs are caller-allocated at
// worst-case nnz size (np.empty: untouched pages never materialize).
//   rb_sbrank[r]  (r < R): rank of rb group r's (slab,bucket) pair
//   sb_pair[s]    (s < n_sb): slab * n_buckets + bucket, ascending
//   chunk_base[s]: first FINAL chunk index of ELL pair s (dummy-shifted)
//   pair_rank[s] : dense block index + 1, or 0 for ELL pairs
//   out_counts   : [n_sb, n_chunks_total(incl dummies), n_dense_real, R,
//                   resolved G]
// Returns R >= 0, or -1 when a row's columns are not sorted ascending.
int64_t sell_pack_plan(int64_t n, int64_t n_cols, int64_t nnz,
                       const int32_t* rp,
                       const int32_t* ci,
                       int32_t W, int32_t K, int32_t G,
                       int64_t dense_min_cnt,
                       int64_t max_dense_blocks,
                       int32_t* rb_sbrank,
                       int64_t* sb_pair,
                       int64_t* chunk_base,
                       int32_t* pair_rank,
                       int64_t* sb_max_out,
                       int64_t* out_counts) {
    const int64_t Gp = G >= 1 ? (int64_t)G : SELL_G_BATCH;
    const int64_t nb = (n_cols + W - 1) / W > 0 ? (n_cols + W - 1) / W : 1;
    const int64_t n_blocks =
        ((n + SELL_C * SELL_SLABS_PER_BLOCK - 1) /
         (SELL_C * SELL_SLABS_PER_BLOCK));

    // pass 1: rb groups (CSR order)
    int64_t* rb_sb = (int64_t*)malloc(sizeof(int64_t) * (size_t)nnz);
    int32_t* rb_cnt = (int32_t*)malloc(sizeof(int32_t) * (size_t)nnz);
    if (!rb_sb || !rb_cnt) { free(rb_sb); free(rb_cnt); return -2; }
    int64_t R = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t slab = i / SELL_C;
        int64_t prev_b = -1;
        int32_t prev_c = -1;
        for (int64_t j = rp[i]; j < rp[i + 1]; ++j) {
            const int32_t c = ci[j];
            if (c < prev_c) { free(rb_sb); free(rb_cnt); return -1; }
            prev_c = c;
            const int64_t b = c / W;
            if (b != prev_b) {
                rb_sb[R] = slab * nb + b;
                rb_cnt[R] = 1;
                ++R;
                prev_b = b;
            } else {
                ++rb_cnt[R - 1];
            }
        }
    }

    // sort rb indices by sb (stable; rb index asc within equal sb)
    int64_t* idx = (int64_t*)malloc(sizeof(int64_t) * (size_t)R);
    if (!idx) { free(rb_sb); free(rb_cnt); return -2; }
    for (int64_t r = 0; r < R; ++r) idx[r] = r;
    std::stable_sort(idx, idx + R, [&](int64_t a, int64_t b) {
        return rb_sb[a] < rb_sb[b];
    });

    // unique sb: pair list, total count, max rb count, rank per rb
    int64_t n_sb = 0;
    int64_t* sb_cnt = (int64_t*)malloc(sizeof(int64_t) * (size_t)R);
    int64_t* sb_max = (int64_t*)malloc(sizeof(int64_t) * (size_t)R);
    if (!sb_cnt || !sb_max) {
        free(rb_sb); free(rb_cnt); free(idx); free(sb_cnt); free(sb_max);
        return -2;
    }
    for (int64_t k = 0; k < R; ++k) {
        const int64_t r = idx[k];
        if (n_sb == 0 || rb_sb[r] != sb_pair[n_sb - 1]) {
            sb_pair[n_sb] = rb_sb[r];
            sb_cnt[n_sb] = 0;
            sb_max[n_sb] = 0;
            ++n_sb;
        }
        sb_cnt[n_sb - 1] += rb_cnt[r];
        if (rb_cnt[r] > sb_max[n_sb - 1]) sb_max[n_sb - 1] = rb_cnt[r];
        rb_sbrank[r] = (int32_t)(n_sb - 1);
    }
    free(rb_sb); free(rb_cnt); free(idx);

    // dense classification: count >= threshold, capped at the
    // max_dense_blocks largest counts (ties: larger count first, then
    // smaller sb — numpy's reversed argsort is unstable on ties, so the
    // cap case is deterministic here but not bit-matched there)
    int64_t n_dense = 0;
    for (int64_t s = 0; s < n_sb; ++s)
        if (sb_cnt[s] >= dense_min_cnt) ++n_dense;
    int64_t cnt_floor = dense_min_cnt;   // keep sb with cnt >= floor ...
    int64_t floor_skip = 0;              // ... skipping this many AT floor
    if (max_dense_blocks <= 0) {
        // cap of zero (max_dense_bytes below one block): demote every
        // dense candidate to ELL — matches the numpy packer's empty keep
        cnt_floor = INT64_MAX;
        n_dense = 0;
    } else if (n_dense > max_dense_blocks) {
        int64_t* cands = (int64_t*)malloc(sizeof(int64_t) * (size_t)n_dense);
        if (!cands) { free(sb_cnt); free(sb_max); return -2; }
        int64_t m = 0;
        for (int64_t s = 0; s < n_sb; ++s)
            if (sb_cnt[s] >= dense_min_cnt) cands[m++] = sb_cnt[s];
        std::nth_element(cands, cands + max_dense_blocks - 1, cands + m,
                         std::greater<int64_t>());
        cnt_floor = cands[max_dense_blocks - 1];
        int64_t above = 0;
        for (int64_t k = 0; k < m; ++k) if (cands[k] > cnt_floor) ++above;
        // keep (max_dense_blocks - above) pairs AT the floor; skip the rest
        int64_t at_floor_total = 0;
        for (int64_t k = 0; k < m; ++k) if (cands[k] == cnt_floor) ++at_floor_total;
        floor_skip = at_floor_total - (max_dense_blocks - above);
        free(cands);
        n_dense = max_dense_blocks;
    }
    int64_t rank = 0, skipped = 0;
    for (int64_t s = 0; s < n_sb; ++s) {
        bool dense = sb_cnt[s] >= cnt_floor && sb_cnt[s] >= dense_min_cnt;
        if (dense && sb_cnt[s] == cnt_floor && skipped < floor_skip) {
            // over-cap tie at the floor: drop later (larger-sb) pairs first?
            // numpy's tie order is unspecified; we drop the EARLIEST at the
            // floor deterministically (skip first) — documented divergence.
            dense = false;
            ++skipped;
        }
        pair_rank[s] = dense ? (int32_t)(++rank) : 0;
    }

    // ELL layers per sb, per-block real-chunk counts, dummy padding
    int64_t* covered = (int64_t*)calloc((size_t)n_blocks, sizeof(int64_t));
    if (!covered) { free(sb_cnt); free(sb_max); return -2; }
    for (int64_t s = 0; s < n_sb; ++s) {
        if (pair_rank[s]) continue;
        const int64_t layers = (sb_max[s] + K - 1) / K;
        covered[(sb_pair[s] / nb) / SELL_SLABS_PER_BLOCK] += layers;
    }

    // G auto-pick (G < 1): take the largest candidate whose EXACT
    // padding over the real per-block chunk counts stays within 2%
    // (mirrors ops/sell.py:_auto_g).
    int64_t Gpick = Gp;
    if (G < 1) {
        int64_t total_real = 0;
        for (int64_t b = 0; b < n_blocks; ++b) total_real += covered[b];
        static const int64_t cands[3] = {16, 8, 4};
        Gpick = 4;
        for (int ci_ = 0; ci_ < 3; ++ci_) {
            const int64_t g = cands[ci_];
            int64_t pad = 0;
            for (int64_t b = 0; b < n_blocks; ++b)
                pad += covered[b] == 0 ? g : (g - covered[b] % g) % g;
            if (pad * 50 <= total_real) { Gpick = g; break; }
        }
    }
    // need[b] folded into a prefix: dummies of block b sit after the reals
    // of the block's first slab
    int64_t n_dummy = 0;
    int64_t* need_prefix = (int64_t*)malloc(sizeof(int64_t) * (size_t)(n_blocks + 1));
    if (!need_prefix) { free(sb_cnt); free(sb_max); free(covered); return -2; }
    need_prefix[0] = 0;
    for (int64_t b = 0; b < n_blocks; ++b) {
        const int64_t need = covered[b] == 0
            ? Gpick
            : (Gpick - covered[b] % Gpick) % Gpick;
        need_prefix[b + 1] = need_prefix[b] + need;
        n_dummy += need;
    }

    int64_t raw = 0;
    for (int64_t s = 0; s < n_sb; ++s) {
        const int64_t slab = sb_pair[s] / nb;
        const int64_t blk = slab / SELL_SLABS_PER_BLOCK;
        const int64_t in_blk = slab % SELL_SLABS_PER_BLOCK;
        const int64_t shift = need_prefix[blk] +
            (in_blk > 0 ? (need_prefix[blk + 1] - need_prefix[blk]) : 0);
        chunk_base[s] = raw + shift;
        if (!pair_rank[s]) raw += (sb_max[s] + K - 1) / K;
    }
    chunk_base[n_sb] = raw + n_dummy;

    out_counts[0] = n_sb;
    out_counts[1] = raw + n_dummy;
    out_counts[2] = rank;
    out_counts[3] = R;
    out_counts[4] = Gpick;  // resolved G (== G when caller fixed it)
    memcpy(sb_max_out, sb_max, sizeof(int64_t) * (size_t)n_sb);
    free(sb_cnt); free(sb_max); free(covered); free(need_prefix);
    return R;
}

// Phase 2: scatter.  All output arrays are caller-allocated and
// zero-initialized (np.zeros / calloc — padding cells must stay 0).
//   data:     (n_chunks, K, C) out dtype (f64 when is_f32 == 0, else f32)
//   cols:     (n_chunks, K, C) int32, bucket-relative columns
//   packed:   (n_chunks, 2K, C) f32 — vals then bitcast cols
//   packed_lo:(n_chunks, K, C) f32 low halves (df64 != 0), else unused
//   dense_hi/dense_lo: (n_dense+1, W, C) f32 (block 0 stays zero)
//   chunk_slab/chunk_bucket: per final chunk (dummies: first slab, 0)
//   dense_slab/dense_bucket: per dense pair, sb-ascending (no dummies)
int sell_pack_fill(int64_t n, int64_t n_cols, int64_t nnz,
                    const int32_t* rp,
                    const int32_t* ci,
                    const double* v,
                    int32_t W, int32_t K, int32_t G,
                    int64_t n_sb,
                    const int32_t* rb_sbrank,
                    const int64_t* sb_pair,
                    const int64_t* chunk_base,
                    const int32_t* pair_rank,
                    const int64_t* sb_max,
                    int is_f32, int df64,
                    void* data, int32_t* cols,
                    float* packed, float* packed_lo,
                    float* dense_hi, float* dense_lo,
                    int64_t* chunk_slab, int32_t* chunk_bucket,
                    int64_t* dense_slab, int32_t* dense_bucket) {
    const int64_t Gp = G >= 1 ? (int64_t)G : SELL_G_BATCH;
    const int64_t nb = (n_cols + W - 1) / W > 0 ? (n_cols + W - 1) / W : 1;
    const int64_t n_blocks =
        ((n + SELL_C * SELL_SLABS_PER_BLOCK - 1) /
         (SELL_C * SELL_SLABS_PER_BLOCK));
    const int64_t KC = (int64_t)K * SELL_C;
    float* dataf = (float*)data;
    double* datad = (double*)data;

    // chunk metadata lists (sb-scale loop), including dummies
    {
        // recompute per-block dummy need
        int64_t* covered = (int64_t*)calloc((size_t)n_blocks, sizeof(int64_t));
        int64_t* ell_layers = (int64_t*)malloc(sizeof(int64_t) * (size_t)(n_sb ? n_sb : 1));
        if (!covered || !ell_layers) { free(covered); free(ell_layers); return -2; }
        for (int64_t s = 0; s < n_sb; ++s) {
            if (pair_rank[s]) { ell_layers[s] = 0; continue; }
            ell_layers[s] = (sb_max[s] + K - 1) / K;
            covered[(sb_pair[s] / nb) / SELL_SLABS_PER_BLOCK] += ell_layers[s];
        }
        // emit: reals in sb order at chunk_base, dummies per block after
        // the block's first slab
        int64_t dense_i = 0;
        for (int64_t s = 0; s < n_sb; ++s) {
            const int64_t slab = sb_pair[s] / nb;
            const int32_t bucket = (int32_t)(sb_pair[s] % nb);
            if (pair_rank[s]) {
                dense_slab[dense_i] = slab;
                dense_bucket[dense_i] = bucket;
                ++dense_i;
                continue;
            }
            int64_t base = chunk_base[s];
            for (int64_t l = 0; l < ell_layers[s]; ++l) {
                chunk_slab[base + l] = slab;
                chunk_bucket[base + l] = bucket;
            }
        }
        // dummies: need[b] chunks at slab b*SLABS_PER_BLOCK.  Their final
        // position: after all reals with slab <= b*8 and before reals with
        // slab > b*8.  Compute positions by walking blocks with running
        // totals of raw chunks per slab.
        int64_t* raw_upto_slab = (int64_t*)calloc(
            (size_t)(n_blocks * SELL_SLABS_PER_BLOCK + 1), sizeof(int64_t));
        if (raw_upto_slab) {
            for (int64_t s = 0; s < n_sb; ++s)
                if (!pair_rank[s]) raw_upto_slab[sb_pair[s] / nb + 1] += ell_layers[s];
            for (int64_t t = 1; t <= n_blocks * SELL_SLABS_PER_BLOCK; ++t)
                raw_upto_slab[t] += raw_upto_slab[t - 1];
            int64_t dummy_before = 0;
            for (int64_t b = 0; b < n_blocks; ++b) {
                const int64_t need = covered[b] == 0
                    ? Gp
                    : (Gp - covered[b] % Gp) % Gp;
                // raw chunks with slab <= b*8  ==  raw_upto_slab[b*8 + 1]
                const int64_t pos = raw_upto_slab[b * SELL_SLABS_PER_BLOCK + 1]
                    + dummy_before;
                for (int64_t d = 0; d < need; ++d) {
                    chunk_slab[pos + d] = b * SELL_SLABS_PER_BLOCK;
                    chunk_bucket[pos + d] = 0;
                }
                dummy_before += need;
            }
            free(raw_upto_slab);
        }
        free(covered); free(ell_layers);
    }

    // entry scatter pass
    int64_t rbi = -1;
    int64_t seq = 0;
    int64_t sbr = -1;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t row_local = i % SELL_C;
        int64_t prev_b = -1;
        for (int64_t j = rp[i]; j < rp[i + 1]; ++j) {
            const int32_t c = ci[j];
            const int64_t b = c / W;
            if (b != prev_b) {
                ++rbi;
                sbr = rb_sbrank[rbi];
                seq = 0;
                prev_b = b;
            }
            const int32_t col_rel = (int32_t)(c - b * W);
            const double val = v[j];
            const float hi = (float)val;
            const int32_t pr = pair_rank[sbr];
            if (pr > 0) {
                const int64_t flat =
                    ((int64_t)pr * W + col_rel) * SELL_C + row_local;
                dense_hi[flat] += hi;
                if (df64) dense_lo[flat] += (float)(val - (double)hi);
            } else {
                const int64_t chunk = chunk_base[sbr] + seq / K;
                const int64_t slot = seq % K;
                const int64_t cell = slot * SELL_C + row_local;
                const int64_t base_kc = chunk * KC;
                if (is_f32) dataf[base_kc + cell] = hi;
                else        datad[base_kc + cell] = val;
                cols[base_kc + cell] = col_rel;
                float* pk = packed + chunk * 2 * KC;
                pk[cell] = hi;
                memcpy(&pk[KC + cell], &col_rel, sizeof(float));
                if (df64)
                    packed_lo[base_kc + cell] = (float)(val - (double)hi);
            }
            ++seq;
        }
    }
    return 0;
}

}  // extern "C"
