// Waterman-Smith-Beyer (general gap cost) alignment DP scores, two entries:
//   gather: raw[s, q] = best cell of the DP of slice s against query q, where
//           S[i, j] = table[tokens[s, i], j, q] (the gather is fused in);
//   flat:   raw[b] = best cell of the DP of S[b] ([B, L, T]).
// H[i, j] = max(H[i-1, j-1] + S[i-1, j-1], max_g H[i-g, j] - w_s[g],
//               max_g H[i, j-g] - w_t[g] [, 0 local]).
//
// Replaces: _make_general_kernel / _pallas_call_scores_general /
// pallas_align_scores_general in vectorian_tpu/ops/pallas_dp.py.  On the
// TPU the corpus pass gathered the similarity block in XLA and flattened it
// to [c*Q, L, T] before the kernel; here the gather entry reads the stacked
// table itself (q fastest, as csrc/affine_dp.cu), so the gathered block never
// reaches device memory.
//
// What bounds it on an H100: WSB keeps every DP row of a problem, and each
// cell maxes over all earlier rows of its column (vertical gaps) and all
// earlier columns of its row (horizontal gaps, against the min-plus closure
// w_t* of the t-side costs, which makes one pass exact).  At row i and column
// j a cell costs about 2*i + 2*j + 4 f32 operations against 4 bytes of token
// id in and 4 bytes of score out per problem, so the kernel is bound by f32
// operations (and, in this simple form, by the loads of the stored rows that
// feed them).
//
// What the simple design does about it: one thread per problem; the rows of
// a problem live in shared memory when enough threads a block fit there,
// else in a device scratch buffer the wrapper allocates for the threads in
// flight (the grid then walks over the problems).  Both go through one
// pointer and stride, with the thread index fastest, so a warp's row reads
// are conflict-free (shared) or coalesced (scratch); the block size is a
// template constant, so shared rows take 32-bit shared-memory addresses
// with immediate column offsets.  Columns are processed in
// register tiles of CH: per stored row one uniform cost load serves CH
// candidates.  Rows stop at the slice's length and columns at the needle's
// (no cell past them can change the score), so the work is what the data
// needs.  Horizontal gaps run in place over the row, highest tile first, so
// every tile reads C values not yet replaced by H.
//
// Exactness contract: the DP is adds, subtractions and maxes only, each
// candidate one rounding (Hall - w, H_prev + S), so the scores are bit-equal
// to the JAX reference (pallas_align_scores_general, align_scores_general)
// in any order of the maxes.  Built with --fmad=false all the same.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG = -1e30f;
constexpr int CH = 8;  // columns per register tile
enum Locality { LOCAL = 0, GLOBAL = 1, SEMIGLOBAL = 2 };

// THREADS > 0: a block of THREADS threads keeps its rows in shared memory;
// THREADS == 0: the rows live in ``scratch`` (one slot per thread of the grid).
template <int LOC, bool GATHER, int THREADS>
__global__ void __launch_bounds__(128) wsb_dp_kernel(
    const float* __restrict__ S,         // gather: table [V, T, Q]; flat: [B, L, T]
    const int32_t* __restrict__ tokens,  // gather: [n, L]; flat: unused
    const int32_t* __restrict__ len_s,   // [n] / [B]
    const int32_t* __restrict__ len_t,   // [Q] / [B], 0 <= len_t <= T
    const float* __restrict__ w_s,       // [L + 1] raw s-side costs
    const float* __restrict__ w_t,       // [T + 1] raw t-side costs (global row 0)
    const float* __restrict__ w_ts,      // [T + 1] closure of w_t
    float* __restrict__ out,             // [problems]
    float* scratch,                      // rows in device memory, or null: shared
    int64_t problems, int L, int T, int Q) {
  // cell (r, j) of this thread's problem at base[r * rs + j * cs]
  using I = typename std::conditional<(THREADS > 0), int, int64_t>::type;
  extern __shared__ float smem[];
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  float* const base = (THREADS > 0) ? smem + threadIdx.x : scratch + tid;
  const I cs = (THREADS > 0) ? (I)THREADS : (I)nthreads;
  const I rs = (I)(T + 1) * cs;
  auto at = [&](int r, int j) -> float& { return base[(I)r * rs + (I)j * cs]; };

  for (int64_t p = tid; p < problems; p += nthreads) {
    const int64_t s = GATHER ? p / Q : p;
    const int q = GATHER ? (int)(p - s * Q) : 0;
    const int ln = len_s[s];
    const int lt = GATHER ? len_t[q] : len_t[p];

    for (int j = 0; j <= lt; ++j)
      at(0, j) = (LOC == GLOBAL && j > 0) ? -w_t[j] : 0.0f;
    float best = (LOC == GLOBAL) ? NEG : 0.0f;

    const int rows = min(ln, L);
    for (int i = 1; i <= rows; ++i) {
      // similarity row i - 1: column j - 1 at srow[(j - 1) * scs]
      const float* srow;
      int64_t scs;
      if (GATHER) {
        srow = S + (int64_t)tokens[s * L + i - 1] * T * Q + q;
        scs = Q;
      } else {
        srow = S + (s * L + i - 1) * (int64_t)T;
        scs = 1;
      }

      // C = max(diagonal, vertical gaps[, 0]) into row i, columns 1..lt
      for (int j0 = 1; j0 <= lt; j0 += CH) {
        float v[CH];
#pragma unroll
        for (int u = 0; u < CH; ++u) v[u] = NEG;
        for (int r = 0; r < i; ++r) {
          const float w = w_s[i - r];
          const float* hr = &at(r, j0);
#pragma unroll
          for (int u = 0; u < CH; ++u)
            if (j0 + u <= lt) v[u] = fmaxf(v[u], hr[(I)u * cs] - w);
        }
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const int j = j0 + u;
          if (j <= lt) {
            const float m = at(i - 1, j - 1) + __ldg(srow + (j - 1) * scs);
            float c = fmaxf(m, v[u]);
            if (LOC == LOCAL) c = fmaxf(c, 0.0f);
            at(i, j) = c;
          }
        }
      }
      at(i, 0) = (LOC == GLOBAL) ? -w_s[i] : 0.0f;

      // horizontal gaps: H[j] = max(C[j], max_g C[j - g] - w_t*[g]), in
      // place, highest tile first (lower columns still hold C)
      float colmax = NEG;
      for (int j0 = ((lt - 1) / CH) * CH + 1; j0 >= 1; j0 -= CH) {
        float e[CH], cc[CH];
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          e[u] = NEG;
          cc[u] = (j0 + u <= lt) ? at(i, j0 + u) : NEG;
        }
        const int top = min(j0 + CH - 1, lt);
        for (int g = 1; g <= top; ++g) {
          const float w = w_ts[g];
          const float* hk = &at(i, j0 - g);  // column j0 + u - g at hk[u * cs]
#pragma unroll
          for (int u = 0; u < CH; ++u) {
            if (j0 + u - g >= 0 && j0 + u <= lt)
              e[u] = fmaxf(e[u], hk[(I)u * cs] - w);
          }
        }
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          if (j0 + u <= lt) {
            const float h = fmaxf(cc[u], e[u]);
            at(i, j0 + u) = h;
            colmax = fmaxf(colmax, h);
          }
        }
      }
      const float h_end = at(i, lt);
      // every row of this loop has i <= len_s
      if (LOC == LOCAL) {
        best = fmaxf(best, colmax);
      } else if (LOC == GLOBAL) {
        if (i == ln) best = h_end;
      } else {
        best = fmaxf(best, h_end);
        if (i == ln) best = fmaxf(best, colmax);
      }
    }
    out[p] = best;
  }
}

using KernelFn = void (*)(const float*, const int32_t*, const int32_t*,
                         const int32_t*, const float*, const float*,
                         const float*, float*, float*, int64_t, int, int, int);

template <bool GATHER, int THREADS>
KernelFn pick(int locality) {
  switch (locality) {
    case LOCAL: return wsb_dp_kernel<LOCAL, GATHER, THREADS>;
    case GLOBAL: return wsb_dp_kernel<GLOBAL, GATHER, THREADS>;
    default: return wsb_dp_kernel<SEMIGLOBAL, GATHER, THREADS>;
  }
}

template <bool GATHER>
int launch(int locality, int blocks, int threads, int smem_bytes,
           cudaStream_t stream, const float* S, const int32_t* tokens,
           const int32_t* len_s, const int32_t* len_t, const float* w_s,
           const float* w_t, const float* w_ts, float* out, float* scratch,
           int64_t problems, int L, int T, int Q) {
  KernelFn kernel;
  if (scratch != nullptr) kernel = pick<GATHER, 0>(locality);
  else if (threads == 32) kernel = pick<GATHER, 32>(locality);
  else if (threads == 64) kernel = pick<GATHER, 64>(locality);
  else if (threads == 128) kernel = pick<GATHER, 128>(locality);
  else return -1;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, threads, smem_bytes, stream>>>(
      S, tokens, len_s, len_t, w_s, w_t, w_ts, out, scratch, problems, L, T, Q);
  return (int)cudaGetLastError();
}

bool bad_args(int64_t problems, int L, int T, int locality, int blocks,
              int threads, int smem_bytes, const float* scratch) {
  if (problems <= 0 || L <= 0 || T <= 0 || locality < 0 || locality > 2)
    return true;
  if (blocks <= 0 || threads <= 0 || threads > 128 || smem_bytes < 0)
    return true;
  // shared rows need every thread's (L + 1) x (T + 1) floats
  if (scratch == nullptr &&
      (int64_t)smem_bytes < (int64_t)(L + 1) * (T + 1) * threads * 4)
    return true;
  return false;
}

}  // namespace

// Both entries return the cudaError_t of the launch (0 on success), or -1
// when the arguments are outside what the kernel takes.  ``scratch`` is null
// for rows in shared memory (smem_bytes per block of 32, 64 or 128
// threads), else a buffer of blocks * threads * (L + 1) * (T + 1) floats.
extern "C" int vt_wsb_dp_scores(
    const float* table, const int32_t* tokens, const int32_t* len_s,
    const int32_t* len_t, const float* w_s, const float* w_t, const float* w_ts,
    float* out, float* scratch, int64_t n, int L, int T, int Q, int locality,
    int blocks, int threads, int smem_bytes, void* stream) {
  if (Q <= 0) return -1;
  const int64_t problems = n * (int64_t)Q;
  if (bad_args(problems, L, T, locality, blocks, threads, smem_bytes, scratch))
    return -1;
  return launch<true>(locality, blocks, threads, smem_bytes,
                      (cudaStream_t)stream, table, tokens, len_s, len_t, w_s,
                      w_t, w_ts, out, scratch, problems, L, T, Q);
}

extern "C" int vt_wsb_dp_scores_flat(
    const float* S, const int32_t* len_s, const int32_t* len_t,
    const float* w_s, const float* w_t, const float* w_ts, float* out,
    float* scratch, int64_t B, int L, int T, int locality, int blocks,
    int threads, int smem_bytes, void* stream) {
  if (bad_args(B, L, T, locality, blocks, threads, smem_bytes, scratch))
    return -1;
  return launch<false>(locality, blocks, threads, smem_bytes,
                       (cudaStream_t)stream, S, nullptr, len_s, len_t, w_s,
                       w_t, w_ts, out, scratch, B, L, T, 1);
}
