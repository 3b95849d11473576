// Affine-gap (Gotoh) alignment DP scores, two entries:
//   gather: raw[s, q] = best cell of the DP of slice s against query q, where
//           S[i, j] = table[tokens[s, i], j, q] (the gather is fused in);
//   flat:   raw[b] = best cell of the DP of S[b] ([B, L, T], one problem a
//           thread, per-problem len_s and len_t), the score-only rescore.
//
// Replaces: _make_multiq_kernel / _dp_one_slice / pallas_align_scores_multi_nt
// (gather) and _make_kernel / _pallas_call_scores / pallas_align_scores
// (flat) in vectorian_tpu/ops/pallas_dp.py.  On the TPU the gather stayed in XLA
// (Mosaic cannot gather inside VMEM) and the kernel read the [L, c, Tp, Q]
// gather output; here each thread loads its own table rows, so the gathered
// stream never touches device memory.
//
// What bounds it on an H100: the bytes it must move are the token ids in and
// the [n, Q] f32 scores out (the [V, Tpad, Q] table, 5 MB at V=5,000,
// Tpad=8 and Q=32, stays in the 50 MB L2).  Against those bytes every DP
// cell costs about 8 + 2*log2(T1P) f32 operations (diagonal add, the two
// vertical-gap candidates and their max, the local clamp, the horizontal
// open, a sub+max per doubling step, the final max and the row reduction):
// at 1M slices of 9 tokens and Q=32 that is ~190 MB against ~40 GFLOP, so
// the kernel is bound by f32 operations, not bytes.
//
// What the simple design does about it: one thread per (slice, query)
// problem; threadIdx walks q fastest, so a warp's table reads
// table[tok, j, q..q+31] coalesce and the token id is a broadcast; the
// H/F/E rows live in registers (T1P is a template parameter, fully
// unrolled); rows past the slice's length are skipped (no cell past len_s
// can change the score).  A warp per slice, shared-memory table tiles and
// cp.async prefetch are later work.  The flat entry is the same kernel with
// row i of problem b read from S[b, i, :] (a thread's T floats are
// contiguous; the rescore batches it serves are small).
//
// Exactness contract: every add, subtract and multiply happens in the JAX
// reference's order (vectorian_tpu/ops/pallas_dp.py _dp_one_slice), so the
// scores are bit-equal to it.  The global boundary costs
// -(open + (k - 1) * extend) are ONE fused multiply-add (__fmaf_rn): the
// JAX reference's XLA build contracts them so, and the torch plain version
// computes the same correctly rounded values on the host.  Everything else
// is built with --fmad=false, so no other product is contracted.
// The horizontal gap is the decayed prefix max by doubling
// (E = max(E, E[j - shift] - decay * shift)), never the sequential
// recurrence, which is mathematically equal but rounds differently.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
enum Locality { LOCAL = 0, GLOBAL = 1, SEMIGLOBAL = 2 };

template <int T1P, int LOC, bool FLAT>
__global__ void __launch_bounds__(128) affine_dp_kernel(
    const float* __restrict__ table,      // gather: [V, Tpad, Q]; flat: [n, L, Tpad]
    const int32_t* __restrict__ tokens,   // gather: [n, L]; flat: unused
    const int32_t* __restrict__ len_s,    // [n], >= 0
    const int32_t* __restrict__ len_t,    // gather: [Q]; flat: [n]; 1 <= len_t <= Tpad
    float* __restrict__ out,              // [n, Q]
    int64_t n, int L, int Tpad, int Q,
    float open_s, float ext_s, float open_t, float ext_t) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n * (int64_t)Q) return;
  const int64_t s = p / Q;
  const int q = (int)(p - s * Q);
  const int ln = len_s[s];
  const int lt = len_t[FLAT ? s : q];
  const float decay = fminf(open_t, ext_t);
  const int64_t row_stride = (int64_t)Tpad * Q;

  float H[T1P], Fv[T1P], E[T1P];
#pragma unroll
  for (int j = 0; j < T1P; ++j) {
    float h0 = 0.0f;
    if (LOC == GLOBAL && j > 0)
      h0 = -__fmaf_rn((float)j - 1.0f, ext_t, open_t);
    H[j] = (j <= lt) ? h0 : NEG;
    Fv[j] = NEG;
  }
  float best = (LOC == GLOBAL) ? NEG : 0.0f;

  const int rows = min(ln, L);
  const int32_t* tok_row = FLAT ? nullptr : tokens + s * (int64_t)L;
  for (int i = 0; i < rows; ++i) {
    const int dp_i = i + 1;
    const int64_t row = FLAT ? s * (int64_t)L + i : (int64_t)tok_row[i];
    const float* srow = table + row * row_stride + q;
    float init_col = 0.0f;
    if (LOC == GLOBAL)
      init_col = -__fmaf_rn((float)dp_i - 1.0f, ext_s, open_s);

    // C (kept in H): diagonal, vertical gap, local floor, boundary column.
    // Descending j reads H[j - 1] of the previous row before it is replaced.
#pragma unroll
    for (int j = T1P - 1; j >= 0; --j) {
      const float sv = (j >= 1 && j <= Tpad) ? __ldg(srow + (int64_t)(j - 1) * Q) : 0.0f;
      const float m = (j >= 1 ? H[j - 1] : NEG) + sv;
      const float f = fmaxf(H[j] - open_s, Fv[j] - ext_s);
      float c = fmaxf(m, f);
      if (LOC == LOCAL) c = fmaxf(c, 0.0f);
      if (j == 0) c = init_col;
      Fv[j] = f;
      H[j] = c;
    }
    // Horizontal gap: E = shift_down(C, 1) - open_t, then the decayed
    // prefix max by doubling (descending j reads the previous step's E).
#pragma unroll
    for (int j = T1P - 1; j >= 1; --j) E[j] = H[j - 1] - open_t;
    E[0] = NEG - open_t;
#pragma unroll
    for (int shift = 1; shift < T1P; shift *= 2) {
      const float d = decay * (float)shift;
#pragma unroll
      for (int j = T1P - 1; j >= shift; --j) E[j] = fmaxf(E[j], E[j - shift] - d);
    }
    float colmax = NEG, h_end = NEG;
#pragma unroll
    for (int j = 0; j < T1P; ++j) {
      const float h = fmaxf(H[j], E[j]);
      H[j] = h;
      if (j >= 1 && j <= lt) colmax = fmaxf(colmax, h);
      if (j == lt) h_end = h;
    }
    // Every row of this loop has dp_i <= len_s.
    if (LOC == LOCAL) {
      best = fmaxf(best, colmax);
    } else if (LOC == GLOBAL) {
      if (dp_i == ln) best = h_end;
    } else {
      best = fmaxf(best, h_end);
      if (dp_i == ln) best = fmaxf(best, colmax);
    }
  }
  out[p] = best;
}

template <int T1P, bool FLAT>
void launch(int locality, dim3 grid, dim3 block, cudaStream_t stream,
            const float* table, const int32_t* tokens, const int32_t* len_s,
            const int32_t* len_t, float* out, int64_t n, int L, int Tpad, int Q,
            float open_s, float ext_s, float open_t, float ext_t) {
  switch (locality) {
    case LOCAL:
      affine_dp_kernel<T1P, LOCAL, FLAT><<<grid, block, 0, stream>>>(
          table, tokens, len_s, len_t, out, n, L, Tpad, Q, open_s, ext_s, open_t, ext_t);
      break;
    case GLOBAL:
      affine_dp_kernel<T1P, GLOBAL, FLAT><<<grid, block, 0, stream>>>(
          table, tokens, len_s, len_t, out, n, L, Tpad, Q, open_s, ext_s, open_t, ext_t);
      break;
    default:
      affine_dp_kernel<T1P, SEMIGLOBAL, FLAT><<<grid, block, 0, stream>>>(
          table, tokens, len_s, len_t, out, n, L, Tpad, Q, open_s, ext_s, open_t, ext_t);
      break;
  }
}

template <bool FLAT>
int dispatch(const float* S, const int32_t* tokens, const int32_t* len_s,
             const int32_t* len_t, float* out, int64_t n, int L, int Tpad,
             int Q, float open_s, float ext_s, float open_t, float ext_t,
             int locality, void* stream) {
  if (n <= 0 || L <= 0 || Q <= 0 || Tpad <= 0 || locality < 0 || locality > 2)
    return -1;
  const int64_t problems = n * (int64_t)Q;
  const int threads = 128;
  const int64_t blocks = (problems + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return -1;
  dim3 grid((unsigned)blocks), block(threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (Tpad <= 8)
    launch<9, FLAT>(locality, grid, block, st, S, tokens, len_s, len_t, out, n, L, Tpad, Q, open_s, ext_s, open_t, ext_t);
  else if (Tpad <= 16)
    launch<17, FLAT>(locality, grid, block, st, S, tokens, len_s, len_t, out, n, L, Tpad, Q, open_s, ext_s, open_t, ext_t);
  else if (Tpad <= 32)
    launch<33, FLAT>(locality, grid, block, st, S, tokens, len_s, len_t, out, n, L, Tpad, Q, open_s, ext_s, open_t, ext_t);
  else if (Tpad <= 64)
    launch<65, FLAT>(locality, grid, block, st, S, tokens, len_s, len_t, out, n, L, Tpad, Q, open_s, ext_s, open_t, ext_t);
  else if (Tpad <= 128)
    launch<129, FLAT>(locality, grid, block, st, S, tokens, len_s, len_t, out, n, L, Tpad, Q, open_s, ext_s, open_t, ext_t);
  else
    return -1;
  return (int)cudaGetLastError();
}

}  // namespace

// Both entries return the cudaError_t of the launch (0 on success), or -1
// when the arguments are outside what the kernel takes.
extern "C" int vt_affine_dp_scores(
    const float* table, const int32_t* tokens, const int32_t* len_s,
    const int32_t* len_t, float* out, int64_t n, int L, int Tpad, int Q,
    float open_s, float ext_s, float open_t, float ext_t, int locality,
    void* stream) {
  return dispatch<false>(table, tokens, len_s, len_t, out, n, L, Tpad, Q,
                         open_s, ext_s, open_t, ext_t, locality, stream);
}

extern "C" int vt_affine_dp_scores_flat(
    const float* S, const int32_t* len_s, const int32_t* len_t, float* out,
    int64_t B, int L, int T, float open_s, float ext_s, float open_t,
    float ext_t, int locality, void* stream) {
  return dispatch<true>(S, nullptr, len_s, len_t, out, B, L, T, 1, open_s,
                        ext_s, open_t, ext_t, locality, stream);
}
