// Affine-gap (Gotoh) alignment DP scores, three entries:
//   gather: raw[s, q] = best cell of the DP of slice s against query q, where
//           S[i, j] = table[tokens[s, i], j, q] (the gather is fused in); the
//           table is f32, bf16 or int8 (a quantized ranking table, read
//           packed in its own type; each element becomes f32 exactly right
//           before the DP row that consumes it);
//   rows:   raw[b] = best cell of the DP of problem b = (bucket row r =
//           rows[b], table slot k = qslot[b]), where S[i, j] =
//           table[k * V + tokens[r, i], j] (the stacked [slots * V, Tmax]
//           plan table, read row by row: the gathered S never reaches
//           device memory), per-problem len_s (0 allowed) and len_t; the
//           score-only rescore.  A null ``tokens`` reads the table itself
//           as S ([B * L, Tmax]: row r * L + i), the flat [B, L, T] batch;
//   dense:  raw[s, q] as in the gather entry, where S[i, j] = S[s, i, j, q]
//           of a dense [c, L, Tpad, Q] f32 block (the layout a contextual
//           chunk's [c * L, d] x [d, Tpad * Q] metric GEMM writes, query
//           minor): the gather entry with slice s's row i at "token id"
//           s * L + i, no copy of the block made.
//
// Replaces: _make_multiq_kernel / _dp_one_slice / pallas_align_scores_multi_nt
// (gather, and dense: the contextual batch's block) and _make_kernel / _pallas_call_scores / pallas_align_scores
// (rows; the flat batch is its identity case) in
// vectorian_tpu/ops/pallas_dp.py.  On the TPU the gather stayed in XLA
// (Mosaic cannot gather inside VMEM) and the kernel read the gathered block;
// here each thread loads its own table rows, so the gathered stream never
// touches device memory.
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
// What the design does about it, on the register route (needles up to 64
// tokens; the wide routes below take wider ones, "wide_regs" up to 512
// columns, then "wide_shared" / "wide_scratch" at any width; the gather
// entry's wrapper splits a launch so that each needle takes the route of
// its own width):
// one thread per problem; in
// the gather entry threadIdx walks q fastest, so a warp's table reads
// table[tok, j, q..q+31] coalesce and the token id is a broadcast.  The H/F/E rows live
// in registers and nowhere else: T1P is a template parameter, every loop
// over columns is fully unrolled, and each doubling step is its own
// template instantiation (a loop over the steps, with the inner loop's
// bound depending on the step, stayed rolled and put E on the stack: a
// (4 T1P + 4)-byte frame and ~80 local loads and stores a row).  At T1P =
// 9 (needles up to 8 tokens) the similarity rows are double-buffered in
// registers: row i + 1's table loads and row i + 2's token id are issued
// before row i's arithmetic, so no row starts with a dependent token ->
// table load; wider rows load theirs with the token id one row ahead.
// Where a row's Tpad floats are contiguous (Q = 1, the `find` pass, and
// every row-gather problem) they load as float4.  Problems split into
// (slice, query) with a 32-bit division while they fit.  Rows past the
// slice's length are skipped (no cell past len_s can change the score).
// Blocks of 128 threads: at the 64-87 registers ptxas reports for T1P = 9
// an SM keeps 5-8 of them (20-32 warps), and the small block keeps the tail
// of a launch short.
//
// A bf16 or int8 table (find_batch's quantized ranking pass, never a find).
// What bounded it: in the [V, Tpad, Q] table a thread's row of Tpad columns
// lies Q elements apart, so a row of 8 columns cost 8 byte or half-word
// loads (each with its own address step) and, for int8, 8 int-to-float
// converts (I2F, a pipe at a fraction of the f32 rate) beside ~150 f32
// operations; the rows sat in f32 registers, so the T1P = 9 templates took
// 80 registers and wider rows could not be double-buffered.  It ran slower
// than the f32 kernel whose bytes it quarters or halves (PERF.md).
// What the design does about it: the kernel reads a query-major [V, Q,
// Tpad] copy (ops/dp_kernels.affine_kernel_table, made once a call or a
// corpus pass; at Q = 1 the table itself), so a problem's row is contiguous
// and loads packed, 8 columns a load (8 bytes of int8, 16 of bf16): a
// warp's 32 queries of one slice read 256 / 512 contiguous bytes of one
// token's rows.  The words stay packed (2-16 registers a row) until the DP
// row that consumes them: row i + 1's are loaded before row i's arithmetic
// up to T1P = 33 (QUANT_PREFETCH_T1P; at 65 the second buffer spilled).  A
// bf16 column is then a shift or a mask of its word, an int8 column a byte
// permute and one f32 subtract (int8_byte_f32), with no convert (on the
// card this times the same as the convert would here: PERF.md).  The T1P =
// 17 templates keep four blocks an SM (affine_dp_kernel_4b).  The wide
// routes keep their int8 convert (load4).
//
// The dense entry (ops/dp_kernels.affine_dense_plan): what bounds it is
// the block's bytes, ~16.5 MB read once at a contextual batch's chunk (c =
// 2,048, L 16, Tpad 8, Q 32: 5.0 us), 2 MB at a find's (c = 8,192, Q = 1:
// 0.64 us, under the ~2 us any launch takes on the device).  At one thread
// a problem a find's chunk is 64 blocks on 132 SMs, each thread walking its
// whole row chain alone, and the wrapper clamped len_s with a launch of its
// own.  What the design does about it: a launch of at most
// AFFINE_DENSE_LANES_MAX_PROBLEMS (8,192) problems takes "dense_lanes"
// (affine_dp_dense_lanes_kernel below: a group of lanes a problem, 2,048
// warps at a find's chunk, every row loaded before the first); a larger one
// keeps the register route, which the lanes lost to from 16,384 problems
// on (measured, PERF.md); every dense kernel clamps len_s to >= 1 itself,
// so a call is one launch.
//
// Tag weights (TagArgs; f32 tables only): each S value becomes, right
// before the DP row that consumes it, the JAX package's tag-weighted value
// (ops/search.py _apply_tag_weights and its batch form in
// _bucket_scores_multiquery):
//   w = tw_w[q, j] * (pos[s, i] == tw_p[q, j] ? 1 : 1 - pen[q]),
//   S' = S * w > thr[q] ? S * w : 0,
// in that order, each product and difference one rounding (__fmul_rn,
// __fsub_rn: nothing contracts).  What bounded the tagged register route:
// it rebuilt w in every cell from the needle's weight and pos id (compare,
// select, two multiplies beside the threshold's compare and select: ~6
// instructions on ~16 a cell), and past 8 columns the weights could not
// stay in registers beside the row (hoisted, they spilled: a 976-byte frame
// at T1P = 65), so every row re-read 2 x Tpad of them (3.3-3.5x the
// untagged kernel's time there, 1.8x at T1P = 9).  What the design does
// about it: w depends on the row only through its pos id, so the wrapper
// hands the kernel a weight table, built once a corpus pass on the host
// (ops/dp_kernels.tag_table: W[r, q, j], one row r for each distinct needle
// pos id and one for every other, and rmap, the row of each of the 256 pos
// ids; exact for any pos id, with the same two roundings).  A row then
// costs one lookup of its pos id's table row and Tpad / 4 float4 loads
// (its (row, query) columns are contiguous and 16-byte aligned, so their
// addresses are immediate offsets; a first layout with the queries
// contiguous cost an address computation a column, and ran 0.88x the old
// design at 1.8x the untagged kernel), and a cell one multiply, a compare
// and a select.  The table's rows are read through the read-only cache:
// the rows of the pos ids that occur are a few KB, hot in L1, and a
// block's share of the table (R x its 32 queries x Tpad) is as many floats
// as it reads, so staging it in shared memory would cost what it saves.
// The row-gather entry reads its slot's row of the table.  At T1P = 9 the
// local gather templates are held to 80 registers (six blocks an SM, as
// the untagged ones run; affine_dp_tagged_kernel_6b).  The wide routes (a
// lane a column, 1.0-1.1x their untagged selves) keep the per-cell form,
// with the needle's weights and pos ids [Q, Tpad] read in place.  pos is
// [n, L] like the tokens (compacted with them where a document-side
// filter is on).  The tagged kernels are their own template family
// (affine_dp_tagged_kernel, affine_dp_wide_tagged_kernel, ...), f32 only,
// with TagArgs a kernel parameter of theirs alone: a runtime flag in the
// untagged kernels changed the registers ptxas picked for them, quantized
// ones included, and spilled five of the templates the build's gate checks.
//
// Exactness contract: every add, subtract and multiply happens in the JAX
// reference's order (vectorian_tpu/ops/pallas_dp.py _dp_one_slice), so the
// scores are bit-equal to it (a quantized element converts to f32 exactly,
// as the reference's per-row cast does).  The global boundary costs
// -(open + (k - 1) * extend) are ONE fused multiply-add (__fmaf_rn): the
// JAX reference's XLA build contracts them so, and the torch plain version
// computes the same correctly rounded values on the host.  Everything else
// is built with --fmad=false, so no other product is contracted.
// The horizontal gap is the decayed prefix max by doubling
// (E = max(E, E[j - shift] - decay * shift)), never the sequential
// recurrence, which is mathematically equal but rounds differently.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// The tag-weighted block's inputs (see the header).  Outside the unnamed
// namespace: the C entries take a pointer to it.
struct TagArgs {
  const int8_t* pos;    // [n, L] pos ids of the rows the tokens index
  const float* w;       // needle weights: query (slot) q, column j at q * qs + j
  const int8_t* p;      // needle pos ids, same layout
  const float* pen;     // [Q] (rows: [slots]) pos-mismatch penalty
  const float* thr;     // [Q] (rows: [slots]) similarity threshold
  const float* wt;      // weight table W: row r, query (slot) q, column j at r * wr + q * wq + j
  const int32_t* rmap;  // [256] W's row of each pos id (indexed by its 8 bits)
  int qs, wr, wq;       // wt 16-byte aligned, wr and wq multiples of 4
};

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 128;
// the widest quantized register templates whose next row is loaded before
// the current one's arithmetic (affine_dp_body)
constexpr int QUANT_PREFETCH_T1P = 33;
enum Locality { LOCAL = 0, GLOBAL = 1, SEMIGLOBAL = 2 };
// the gather entry's table types (its C entry's ``table_dtype``)
enum TableDtype { F32 = 0, BF16 = 1, INT8 = 2 };

// A table element as f32, exactly: bf16 (its 16 bits) is the high half of
// the f32 with the same value; int8 is an integer of at most 7 bits.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t x) {
  return __uint_as_float((uint32_t)x << 16);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// Byte k of packed int8 bytes as f32, exactly, without the convert
// instruction (I2F, which issues at a fraction of the f32 rate): ``wx`` is
// the word xor 0x80808080, so byte k is b + 128 (0 ... 255); one byte
// permute puts it under the upper three bytes of 12,582,912.0f's bits
// (0x4B400000), the f32 12,582,912 + b + 128, and one f32 subtract of
// 12,583,040.0f leaves b.  Every value is an integer below 2^24, so neither
// step rounds.
constexpr uint32_t INT8_BIAS_BITS = 0x4B400000u;
constexpr float INT8_BIAS = 12583040.0f;
__device__ __forceinline__ float int8_byte_f32(uint32_t wx, int k) {
  return __uint_as_float(__byte_perm(wx, INT8_BIAS_BITS, 0x7650 | k)) - INT8_BIAS;
}

// Quantized similarity rows (bf16 or int8 tables, read query-major: a
// problem's row of Tpad elements is contiguous) move as packed 32-bit words
// from the load to the DP row: ROW_WORDS<N, E> words hold N columns.
template <int N, typename E>
constexpr int ROW_WORDS = N * (int)sizeof(E) / 4;

// The first Tpad of N columns of a quantized row (Tpad a multiple of 8,
// ``src`` aligned to 16 bytes where its offset is a multiple of 8 elements),
// 8 columns a load: one 8-byte load (int8) or one 16-byte load (bf16);
// zero words past Tpad (zero columns).
template <int N, typename E>
__device__ __forceinline__ void load_packed(uint32_t (&w)[ROW_WORDS<N, E>],
                                            const E* __restrict__ src, int Tpad) {
  static_assert(N % 8 == 0 && sizeof(E) <= 2, "quantized rows of whole 8-column chunks");
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    if constexpr (sizeof(E) == 1) {
      const uint2 x = (8 * c < Tpad) ? __ldg(reinterpret_cast<const uint2*>(src) + c)
                                     : make_uint2(0u, 0u);
      w[2 * c] = x.x;
      w[2 * c + 1] = x.y;
    } else {
      const uint4 x = (8 * c < Tpad) ? __ldg(reinterpret_cast<const uint4*>(src) + c)
                                     : make_uint4(0u, 0u, 0u, 0u);
      w[4 * c] = x.x;
      w[4 * c + 1] = x.y;
      w[4 * c + 2] = x.z;
      w[4 * c + 3] = x.w;
    }
  }
}

// A packed row as the DP row's f32 similarities, exactly: a bf16 column is
// a shift or a mask of its word, an int8 column a byte permute and a
// subtract (int8_byte_f32).
template <int N, typename E>
__device__ __forceinline__ void unpack_row(float (&v)[N], const uint32_t (&w)[ROW_WORDS<N, E>]) {
  if constexpr (sizeof(E) == 2) {
#pragma unroll
    for (int c = 0; c < N / 2; ++c) {
      v[2 * c] = __uint_as_float(w[c] << 16);
      v[2 * c + 1] = __uint_as_float(w[c] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const uint32_t wx = w[c] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k) v[4 * c + k] = int8_byte_f32(wx, k);
    }
  }
}

// The doubling steps of a T1P-wide row, shift = SHIFT, 2 * SHIFT, ... <
// T1P: one instantiation a step, so every loop has a constant trip count
// and every E[j - shift] a constant index (nested loops whose inner bound
// depends on the outer induction variable are not fully unrolled, and E
// then goes to the stack).
template <int T1P, int SHIFT>
__device__ __forceinline__ void doubling(float (&E)[T1P], float decay) {
  if constexpr (SHIFT < T1P) {
    const float d = decay * (float)SHIFT;
#pragma unroll
    for (int j = T1P - 1; j >= SHIFT; --j) E[j] = fmaxf(E[j], E[j - SHIFT] - d);
    doubling<T1P, 2 * SHIFT>(E, decay);
  }
}

// One tag-weighted similarity from its weight ``wv`` (w, or w * (1 -
// pen), already rounded): S * w, then the threshold.
__device__ __forceinline__ float tag_apply(float s, float wv, float thr) {
  const float sw = __fmul_rn(s, wv);
  return (sw > thr) ? sw : 0.0f;
}

// One tag-weighted similarity from the needle column's weight and pos id:
// w first, then S * w, then the threshold.
__device__ __forceinline__ float tag_weight(float s, int pos_s, float w, int pos_t,
                                            float pen, float thr) {
  const float sel = (pos_s == pos_t) ? 1.0f : __fsub_rn(1.0f, pen);
  return tag_apply(s, __fmul_rn(w, sel), thr);
}

// The weight-table row of a similarity row whose pos id is ``ps``, at
// query or table slot k: its columns, contiguous and 16-byte aligned.
__device__ __forceinline__ const float* tag_table_row(const TagArgs& t, int ps, int k) {
  return t.wt + (int64_t)__ldg(t.rmap + (uint8_t)ps) * t.wr + (int64_t)k * t.wq;
}

// A similarity row (its first Tpad of N columns, N a multiple of 4)
// tag-weighted by its weight-table row ``wrow``, read 16 bytes at a time
// through the read-only cache.
template <int N>
__device__ __forceinline__ void tag_row(float (&v)[N], const float* __restrict__ wrow,
                                        int Tpad, float thr) {
  static_assert(N % 4 == 0, "rows of whole float4s");
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    if (4 * c < Tpad) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(wrow) + c);
      v[4 * c] = tag_apply(v[4 * c], x.x, thr);
      v[4 * c + 1] = tag_apply(v[4 * c + 1], x.y, thr);
      v[4 * c + 2] = tag_apply(v[4 * c + 2], x.z, thr);
      v[4 * c + 3] = tag_apply(v[4 * c + 3], x.w, thr);
    }
  }
}

// problem p -> (slice s, query q), in 32 bits while the problems fit
__device__ __forceinline__ void split_problem(int64_t p, int Q, bool small,
                                              int64_t& s, int& q) {
  if (small) {
    const uint32_t pp = (uint32_t)p, ss = pp / (uint32_t)Q;
    s = ss;
    q = (int)(pp - ss * (uint32_t)Q);
  } else {
    s = p / Q;
    q = (int)(p - s * Q);
  }
}

// One similarity row: v[j] = src[j * cs] as f32 for j < Tpad, 0 past it.
// VEC (f32 only): cs == 1, src 16-byte aligned and Tpad % 4 == 0 (float4
// loads).
template <int T1P, bool VEC, typename E>
__device__ __forceinline__ void load_row(float (&v)[T1P - 1],
                                         const E* __restrict__ src,
                                         int64_t cs, int Tpad) {
  static_assert(!VEC || std::is_same<E, float>::value, "float4 rows are f32");
  if constexpr (VEC) {
#pragma unroll
    for (int c = 0; c < (T1P - 1) / 4; ++c) {
      const float4 x = (4 * c < Tpad)
                           ? __ldg(reinterpret_cast<const float4*>(src) + c)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * c] = x.x;
      v[4 * c + 1] = x.y;
      v[4 * c + 2] = x.z;
      v[4 * c + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < T1P - 1; ++j)
      v[j] = (j < Tpad) ? to_f32(__ldg(src + (int64_t)j * cs)) : 0.0f;
  }
}

// DP row dp_i (1-based) from similarity row sv (column j at sv[j - 1]).
template <int T1P, int LOC>
__device__ __forceinline__ void dp_row(float (&H)[T1P], float (&Fv)[T1P],
                                       const float (&sv)[T1P - 1], int dp_i,
                                       int ln, int lt, float open_s,
                                       float ext_s, float open_t, float decay,
                                       float& best) {
  float init_col = 0.0f;
  if (LOC == GLOBAL) init_col = -__fmaf_rn((float)dp_i - 1.0f, ext_s, open_s);

  // C (kept in H): diagonal, vertical gap, local floor, boundary column.
  // Descending j reads H[j - 1] of the previous row before it is replaced.
#pragma unroll
  for (int j = T1P - 1; j >= 0; --j) {
    const float m = (j >= 1 ? H[j - 1] + sv[j - 1] : NEG + 0.0f);
    const float f = fmaxf(H[j] - open_s, Fv[j] - ext_s);
    float c = fmaxf(m, f);
    if (LOC == LOCAL) c = fmaxf(c, 0.0f);
    if (j == 0) c = init_col;
    Fv[j] = f;
    H[j] = c;
  }
  // Horizontal gap: E = shift_down(C, 1) - open_t, then the decayed prefix
  // max by doubling (descending j reads the previous step's E).
  float E[T1P];
#pragma unroll
  for (int j = T1P - 1; j >= 1; --j) E[j] = H[j - 1] - open_t;
  E[0] = NEG - open_t;
  doubling<T1P, 1>(E, decay);
  float colmax = NEG, h_end = NEG;
#pragma unroll
  for (int j = 0; j < T1P; ++j) {
    const float h = fmaxf(H[j], E[j]);
    H[j] = h;
    if (j >= 1 && j <= lt) colmax = fmaxf(colmax, h);
    if (j == lt) h_end = h;
  }
  // Every row has dp_i <= len_s.
  if (LOC == LOCAL) {
    best = fmaxf(best, colmax);
  } else if (LOC == GLOBAL) {
    if (dp_i == ln) best = h_end;
  } else {
    best = fmaxf(best, h_end);
    if (dp_i == ln) best = fmaxf(best, colmax);
  }
}

// DP row dp_i from a packed quantized similarity row, unpacked right before
// the arithmetic that consumes it.
template <int T1P, int LOC, typename E>
__device__ __forceinline__ void packed_dp_row(float (&H)[T1P], float (&Fv)[T1P],
                                              const uint32_t (&w)[ROW_WORDS<T1P - 1, E>],
                                              int dp_i, int ln, int lt, float open_s,
                                              float ext_s, float open_t, float decay,
                                              float& best) {
  float sv[T1P - 1];
  unpack_row<T1P - 1, E>(sv, w);
  dp_row<T1P, LOC>(H, Fv, sv, dp_i, ln, lt, open_s, ext_s, open_t, decay, best);
}

// The arguments of a launch (both entries); passed by value into the
// kernel's parameter bank.
struct Args {
  const void* table;      // gather: [V, Tpad, Q] of E; rows: [slots * V, Tpad] f32
  const int32_t* tokens;  // [n, L]; rows: null = S itself (row r * L + i)
  const int32_t* prow;    // rows: [B] bucket row of each problem
  const int32_t* pslot;   // rows: [B] table slot of each problem
  const int32_t* len_s;   // gather: [n], >= 1; rows: [B], >= 0
  const int32_t* len_t;   // gather: [Q]; rows: [B]; 1 <= len_t <= Tpad
  float* out;             // gather: [n, Q]; rows: [B]
  int64_t n;              // gather: slices; rows: problems
  int L, Tpad, Q;         // rows: Q = 1
  int64_t V;              // rows: table rows a slot
  float open_s, ext_s, open_t, ext_t;
  bool small;             // gather: problems fit 32 bits
  bool mask_empty;        // rows: len_s <= 0 scores NEG
};

// One problem a thread.  E: the table's element type (float, uint16_t for
// bf16, int8_t); the row-gather entry reads the f32 plan table only.
// TAGGED (f32 only): the rows are tag-weighted by ``t``.
// DENSE: the table is a dense [c, L, Tpad, Q] block, slice s's row i at
// s * L + i (no token ids).
template <int T1P, int LOC, bool ROWS, bool VEC, typename E, bool TAGGED,
          bool DENSE = false>
__device__ __forceinline__ void affine_dp_body(const Args a, const TagArgs t) {
  static_assert(!ROWS || std::is_same<E, float>::value, "rows read f32 tables");
  static_assert(!TAGGED || std::is_same<E, float>::value, "tags weight f32 tables");
  // a quantized (bf16 / int8) gather table is query-major and its rows
  // load packed (see the header)
  constexpr bool PACKED = !std::is_same<E, float>::value;
  static_assert(!PACKED || VEC, "quantized rows load packed");
  const int64_t p = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= a.n * (int64_t)a.Q) return;
  // Similarity row i is table + tok(i) * rstride, column j at j * cs:
  // gather table[tokens[s, i], :, q] (column stride Q; a quantized table
  // [V, Q, Tpad], contiguous), rows table[slot * V + tokens[r, i], :]
  // (contiguous).
  int64_t s;
  int ln, lt;
  int k = 0;  // tagged: the query (gather) or table slot (rows)
  const E* base = static_cast<const E*>(a.table);
  int64_t rstride, cs;
  if (ROWS) {
    s = (a.prow != nullptr) ? (int64_t)a.prow[p] : p;
    ln = a.len_s[p];
    lt = a.len_t[p];
    rstride = a.Tpad;
    cs = 1;
    base += (a.pslot != nullptr ? (int64_t)a.pslot[p] * a.V : 0) * rstride;
    // no token ids: the problem's own L rows of S
    if (a.tokens == nullptr) base += s * (int64_t)a.L * rstride;
    if constexpr (TAGGED) k = (a.pslot != nullptr) ? a.pslot[p] : 0;
  } else {
    int q;
    split_problem(p, a.Q, a.small, s, q);
    if constexpr (TAGGED) k = q;
    ln = DENSE ? max(a.len_s[s], 1) : a.len_s[s];  // the dense block's len_s is raw
    lt = a.len_t[q];
    rstride = (int64_t)a.Tpad * a.Q;
    cs = PACKED ? 1 : a.Q;
    base += PACKED ? (int64_t)q * a.Tpad : (int64_t)q;
    if constexpr (DENSE) base += s * (int64_t)a.L * rstride;
  }
  const int32_t* __restrict__ tok_row =
      (a.tokens != nullptr) ? a.tokens + s * (int64_t)a.L : nullptr;
  // token id of similarity row i
  auto tok_at = [&](int i) -> int {
    return (DENSE || (ROWS && tok_row == nullptr)) ? i : __ldg(tok_row + i);
  };
  const int Tpad = a.Tpad;
  const float open_s = a.open_s, ext_s = a.ext_s, open_t = a.open_t;
  const float decay = fminf(a.open_t, a.ext_t);
  // tagged: the threshold of query / slot k, and each similarity row
  // weighted by its pos id's row of the weight table
  float thr = 0.0f;
  if constexpr (TAGGED) thr = __ldg(t.thr + k);
  auto tag = [&](float (&v)[T1P - 1], int ps) {
    tag_row<T1P - 1>(v, tag_table_row(t, ps, k), Tpad, thr);
  };

  float H[T1P], Fv[T1P];
#pragma unroll
  for (int j = 0; j < T1P; ++j) {
    float h0 = 0.0f;
    if (LOC == GLOBAL && j > 0)
      h0 = -__fmaf_rn((float)j - 1.0f, a.ext_t, a.open_t);
    H[j] = (j <= lt) ? h0 : NEG;
    Fv[j] = NEG;
  }
  float best = (LOC == GLOBAL) ? NEG : 0.0f;
  const int rows = min(ln, a.L);

  // Rows of 9 columns are double-buffered in registers: row i + 1's loads
  // (and row i + 2's token id) are issued before row i's arithmetic.
  // Wider rows load as they go, with the token id one row ahead: at T1P =
  // 17 the second buffer took ptxas past its 128-register choice into
  // spills.
  // tagged: the pos id of similarity row i, loaded with the row
  auto pos_at = [&](int i) -> int { return __ldg(t.pos + s * (int64_t)a.L + i); };
  if constexpr (PACKED) {
    // Quantized rows stay packed until the DP row that consumes them: up to
    // T1P = QUANT_PREFETCH_T1P row i + 1's words (and row i + 2's token id)
    // are loaded before row i's arithmetic, in 2-16 registers where f32
    // rows needed 8-32; wider rows load as they go, the token id a row
    // ahead.
    constexpr int N = T1P - 1;
    constexpr int W = ROW_WORDS<N, E>;
    if constexpr (T1P <= QUANT_PREFETCH_T1P) {
      uint32_t wa[W], wb[W];
      int tok_next = 0;
      if (rows > 0) load_packed<N>(wa, base + (int64_t)tok_at(0) * rstride, Tpad);
      if (rows > 1) tok_next = tok_at(1);
      for (int i = 0; i < rows; i += 2) {
        if (i + 1 < rows) {
          load_packed<N>(wb, base + (int64_t)tok_next * rstride, Tpad);
          if (i + 2 < rows) tok_next = tok_at(i + 2);
        }
        packed_dp_row<T1P, LOC, E>(H, Fv, wa, i + 1, ln, lt, open_s, ext_s, open_t, decay, best);
        if (i + 1 >= rows) break;
        if (i + 2 < rows) {
          load_packed<N>(wa, base + (int64_t)tok_next * rstride, Tpad);
          if (i + 3 < rows) tok_next = tok_at(i + 3);
        }
        packed_dp_row<T1P, LOC, E>(H, Fv, wb, i + 2, ln, lt, open_s, ext_s, open_t, decay, best);
      }
    } else {
      int tok = (rows > 0) ? tok_at(0) : 0;
      for (int i = 0; i < rows; ++i) {
        uint32_t w[W];
        load_packed<N>(w, base + (int64_t)tok * rstride, Tpad);
        if (i + 1 < rows) tok = tok_at(i + 1);
        packed_dp_row<T1P, LOC, E>(H, Fv, w, i + 1, ln, lt, open_s, ext_s, open_t, decay, best);
      }
    }
  } else if constexpr (T1P <= 9) {
    float ra[T1P - 1], rb[T1P - 1];
    int pa = 0, pb = 0;  // tagged: the pos ids of ra's and rb's rows
    int tok_next = 0;  // token id of the row after the one being loaded
    if (rows > 0) {
      load_row<T1P, VEC>(ra, base + (int64_t)tok_at(0) * rstride, cs, Tpad);
      if constexpr (TAGGED) pa = pos_at(0);
    }
    if (rows > 1) tok_next = tok_at(1);
    for (int i = 0; i < rows; i += 2) {
      if (i + 1 < rows) {
        load_row<T1P, VEC>(rb, base + (int64_t)tok_next * rstride, cs, Tpad);
        if constexpr (TAGGED) pb = pos_at(i + 1);
        if (i + 2 < rows) tok_next = tok_at(i + 2);
      }
      if constexpr (TAGGED) tag(ra, pa);
      dp_row<T1P, LOC>(H, Fv, ra, i + 1, ln, lt, open_s, ext_s, open_t, decay, best);
      if (i + 1 >= rows) break;
      if (i + 2 < rows) {
        load_row<T1P, VEC>(ra, base + (int64_t)tok_next * rstride, cs, Tpad);
        if constexpr (TAGGED) pa = pos_at(i + 2);
        if (i + 3 < rows) tok_next = tok_at(i + 3);
      }
      if constexpr (TAGGED) tag(rb, pb);
      dp_row<T1P, LOC>(H, Fv, rb, i + 2, ln, lt, open_s, ext_s, open_t, decay, best);
    }
  } else {
    int tok = (rows > 0) ? tok_at(0) : 0;
    for (int i = 0; i < rows; ++i) {
      float sv[T1P - 1];
      load_row<T1P, VEC>(sv, base + (int64_t)tok * rstride, cs, Tpad);
      int ps = 0;
      if constexpr (TAGGED) ps = pos_at(i);
      if (i + 1 < rows) tok = tok_at(i + 1);
      if constexpr (TAGGED) tag(sv, ps);
      dp_row<T1P, LOC>(H, Fv, sv, i + 1, ln, lt, open_s, ext_s, open_t, decay, best);
    }
  }
  a.out[p] = (ROWS && a.mask_empty && ln <= 0) ? NEG : best;
}

template <int T1P, int LOC, bool ROWS, bool VEC, typename E>
__global__ void __launch_bounds__(THREADS) affine_dp_kernel(const Args a) {
  affine_dp_body<T1P, LOC, ROWS, VEC, E, false>(a, TagArgs{});
}

template <int T1P, int LOC, bool ROWS, bool VEC>
__global__ void __launch_bounds__(THREADS)
    affine_dp_tagged_kernel(const Args a, const TagArgs t) {
  affine_dp_body<T1P, LOC, ROWS, VEC, float, true>(a, t);
}

// The dense entry's register route (f32 block, no tags): a family of its
// own, so the gather templates stay as they are.
template <int T1P, int LOC, bool VEC>
__global__ void __launch_bounds__(THREADS) affine_dp_dense_kernel(const Args a) {
  affine_dp_body<T1P, LOC, false, VEC, float, false, true>(a, TagArgs{});
}

// The dense entry's lane route ("dense_lanes"): a group of G lanes (8, 16
// or 32, the power of two >= Tpad) a problem, lane l holding DP column l +
// 1, for launches too few to fill the card one thread a problem (a find's
// Q = 1 chunk: 8,192 problems are 64 blocks of AFFINE_REG_THREADS on 132
// SMs, each thread walking its whole row chain alone).  The wide_regs body
// at one column a lane, over a group instead of a warp: column 0 a per-lane
// scalar, the diagonal's H[j - 1] and E's C[j - 1] one __shfl_up_sync each,
// the doubling's step ``shift`` one more (a lane below shift - 1 has no
// source and subtracts +inf; lane shift - 1 reads column 0's E), the steps
// stopping at the warp's widest needle.  Every row's similarity of the
// lane's column is loaded before the first row, so the row chain waits on
// no load.  The score's maxes run per lane and reduce once a problem; the
// global score comes from the lane holding column len_t.
template <int G, int SHIFT>
__device__ __forceinline__ void lane_doubling(float& E, float decay, float e0, int T1,
                                              int lane) {
  if constexpr (SHIFT <= G) {
    if (SHIFT >= T1) return;  // warp-uniform
    const float d = decay * (float)SHIFT;
    float src = __shfl_up_sync(0xffffffffu, E, SHIFT, G);
    if (lane == SHIFT - 1) src = e0;
    const float dl = (lane >= SHIFT - 1) ? d : __uint_as_float(0x7f800000u);
    E = fmaxf(E, src - dl);
    lane_doubling<G, 2 * SHIFT>(E, decay, e0, T1, lane);
  }
}

template <int LT, int G, int LOC>
__global__ void __launch_bounds__(THREADS) affine_dp_dense_lanes_kernel(const Args a) {
  constexpr unsigned ALL = 0xffffffffu;
  const int64_t gthread = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & (G - 1);
  const int j = lane + 1;  // this lane's DP column
  const int64_t problems = a.n * (int64_t)a.Q;
  const int64_t p_raw = gthread / G;
  const bool valid = p_raw < problems;
  const int64_t p = valid ? p_raw : 0;  // a tail group computes, stores nothing
  int64_t s;
  int q;
  split_problem(p, a.Q, a.small, s, q);
  const int ln = max(a.len_s[s], 1);  // clamped here, not by a launch
  const int lt = a.len_t[q];
  const int rows = valid ? min(ln, a.L) : 0;
  // uniform bounds of the warp: its longest slice, its widest needle's
  // columns that reach a score
  const int rows_warp = __reduce_max_sync(ALL, rows);
  const int T1 = __reduce_max_sync(ALL, valid ? min(lt, a.Tpad) + 1 : 1);
  const float open_s = a.open_s, ext_s = a.ext_s, open_t = a.open_t;
  const float decay = fminf(a.open_t, a.ext_t);
  const float e0 = NEG - open_t;  // E[0]: no doubling step changes it

  // row i of slice s at (s * L + i) * Tpad * Q, column l of query q at l * Q + q
  const int64_t rstride = (int64_t)a.Tpad * a.Q;
  const float* __restrict__ col = static_cast<const float*>(a.table) +
                                  s * (int64_t)a.L * rstride + q + (int64_t)lane * a.Q;
  float sv[LT];
#pragma unroll
  for (int i = 0; i < LT; ++i)
    sv[i] = (i < rows && lane < a.Tpad) ? __ldg(col + i * rstride) : 0.0f;

  float H = NEG;
  if (j <= lt) H = (LOC == GLOBAL) ? -__fmaf_rn((float)j - 1.0f, a.ext_t, a.open_t) : 0.0f;
  float Fv = NEG;
  float h0col = 0.0f;  // H[0]
  float acc = NEG;     // this lane's part of the score (as affine_wide_regs_body)
#pragma unroll
  for (int i = 0; i < LT; ++i) {
    if (i >= rows_warp) break;
    const int dp_i = i + 1;
    float init_col = 0.0f;
    if (LOC == GLOBAL) init_col = -__fmaf_rn((float)dp_i - 1.0f, ext_s, open_s);
    // C: diagonal (lane l - 1's H of the previous row; lane 0: column 0),
    // vertical gap, local floor
    const float h_up = __shfl_up_sync(ALL, H, 1, G);
    const float m = ((lane == 0) ? h0col : h_up) + sv[i];
    const float f = fmaxf(H - open_s, Fv - ext_s);
    float c = fmaxf(m, f);
    if (LOC == LOCAL) c = fmaxf(c, 0.0f);
    Fv = f;
    // horizontal gap: E = shift_down(C, 1) - open_t, then the doubling
    const float c_up = __shfl_up_sync(ALL, c, 1, G);
    float E = ((lane == 0) ? init_col : c_up) - open_t;
    lane_doubling<G, 1>(E, decay, e0, T1, lane);
    const float h = fmaxf(c, E);
    H = h;
    h0col = fmaxf(init_col, e0);
    if (dp_i <= rows) {
      // every counted row has dp_i <= len_s
      if (LOC == LOCAL) {
        if (j <= lt) acc = fmaxf(acc, h);
      } else if (LOC == GLOBAL) {
        if (dp_i == ln && j == lt) acc = h;
      } else {
        if (j == lt) acc = fmaxf(acc, h);
        if (dp_i == ln && j <= lt) acc = fmaxf(acc, h);
      }
    }
  }
  float best;
  if (LOC == GLOBAL) {
    best = __shfl_sync(ALL, acc, lt - 1, G);
  } else {
#pragma unroll
    for (int o = G / 2; o >= 1; o >>= 1) acc = fmaxf(acc, __shfl_xor_sync(ALL, acc, o, G));
    best = fmaxf(0.0f, acc);
  }
  if (valid && lane == 0) a.out[p] = best;
}

// The tagged T1P = 17 templates with four blocks an SM asked for, as
// affine_dp_kernel_4b below: left to itself ptxas kept a fifth block (96
// registers) and spilled one of them.
template <int T1P, int LOC, bool ROWS, bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
    affine_dp_tagged_kernel_4b(const Args a, const TagArgs t) {
  affine_dp_body<T1P, LOC, ROWS, VEC, float, true>(a, t);
}

// The tagged T1P = 9 local gather templates (the corpus pass's) with six
// blocks an SM asked for, at most 80 registers as the untagged ones take:
// left to itself ptxas gave them 96, five blocks (20 warps an SM against
// 24-28).  The other localities and the row-gather entry spilled 4-12
// bytes at six blocks and keep the default.
template <int T1P, int LOC, bool ROWS, bool VEC>
__global__ void __launch_bounds__(THREADS, 6)
    affine_dp_tagged_kernel_6b(const Args a, const TagArgs t) {
  affine_dp_body<T1P, LOC, ROWS, VEC, float, true>(a, t);
}

// ---------------------------------------------------------------------------
// The wide route: needles of any padded width (ops/dp_kernels.py
// affine_launch_plan picks it past AFFINE_WIDE_REGS_MAX_T; below that the
// register-resident wide route further down).  One warp a (slice,
// query) problem; its H, F and two E rows (4 x (Tpad + 1) floats) live in
// shared memory ("wide_shared") or, where too few warps an SM would fit
// there, in a device scratch buffer sized to the warps in flight
// ("wide_scratch"; the grid then walks over the problems).  Lane l owns
// columns l, l + 32, ...: the diagonal's H[j - 1] comes from the lane to
// the left by a shuffle (lane 0 takes the previous chunk's last column),
// so the C pass updates H and F in place, each lane on its own columns.
// The horizontal gap runs the register kernel's doubling, shifts 1, 2, 4,
// ... with d = decay * (float)shift, each step reading one E row and
// writing the other (every source read before any write), __syncwarp
// between steps; shift 1 reads C straight from H.  No column past a
// needle's length can reach one inside it (the diagonal, the vertical gap
// and E only move right or down), and a shift past column j leaves E[j] as
// it was: so a problem computes its needle's len_t + 1 columns only (a
// short needle in a batch padded to a long one costs its own width), and
// the columns the register templates pad with (up to T1P) change no score.
// The two routes are bit-equal, and both equal the plain version.
//
// Coalescing: a lane reads one column of the similarity row, and a row's
// columns are contiguous, so a warp reads 128 contiguous bytes.  Rows of
// the row-gather entry are contiguous as they are.  In the gather entry's
// [V, Tpad, Q] table a row's columns lie Q floats apart (each lane would
// read its own 32-byte sector), so the wrapper hands this route a
// query-major [V, Q, Tpad] copy (at Q = 1 the same memory): query q's row
// of vocab entry v starts at (v * Q + q) * Tpad.
// SCRATCH is a template argument so that the shared-memory variant
// addresses its rows as shared memory, not through generic pointers.
// ---------------------------------------------------------------------------

constexpr int WIDE_WARPS = 8;
constexpr int WIDE_THREADS = 32 * WIDE_WARPS;
constexpr unsigned FULL = 0xffffffffu;

// A row's token id; a null ``tok_row`` (the flat batch) reads row i itself.
__device__ __forceinline__ int wide_token(const int32_t* __restrict__ tok_row, int i) {
  return (tok_row == nullptr) ? i : __ldg(tok_row + i);
}

// DENSE: the [c, L, Tpad, Q] block read in place, a row's columns Q floats
// apart (each lane its own sector; the wide route is a needle past 64
// tokens, rare in a contextual batch, so no query-major copy is made).
template <int LOC, bool ROWS, bool SCRATCH, typename E, bool TAGGED,
          bool DENSE = false>
__device__ __forceinline__ void affine_wide_body(const Args a, float* __restrict__ scratch,
                                                 const TagArgs t) {
  extern __shared__ float smem[];
  static_assert(!ROWS || std::is_same<E, float>::value, "rows read f32 tables");
  static_assert(!TAGGED || std::is_same<E, float>::value, "tags weight f32 tables");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = a.Tpad + 1;  // a row's floats in the warp's buffers
  float* H;
  if constexpr (SCRATCH)
    H = scratch + ((int64_t)blockIdx.x * WIDE_WARPS + warp) * 4 * W;
  else
    H = smem + warp * 4 * W;
  float* const Fv = H + W;
  float* const EA = Fv + W;
  float* const EB = EA + W;
  const float open_s = a.open_s, ext_s = a.ext_s, open_t = a.open_t;
  const float decay = fminf(a.open_t, a.ext_t);
  const int64_t problems = a.n * (int64_t)a.Q;

  for (int64_t p = (int64_t)blockIdx.x * WIDE_WARPS + warp; p < problems;
       p += (int64_t)gridDim.x * WIDE_WARPS) {
    int64_t s;
    int ln, lt;
    int k = 0;  // tagged: the query or table slot
    const E* base = static_cast<const E*>(a.table);
    int64_t rstride;  // between two vocab entries' rows
    if (ROWS) {
      s = (a.prow != nullptr) ? (int64_t)a.prow[p] : p;
      ln = a.len_s[p];
      lt = a.len_t[p];
      rstride = a.Tpad;
      base += (a.pslot != nullptr ? (int64_t)a.pslot[p] * a.V : 0) * rstride;
      if (a.tokens == nullptr) base += s * (int64_t)a.L * rstride;
      if constexpr (TAGGED) k = (a.pslot != nullptr) ? a.pslot[p] : 0;
    } else {
      int q;
      split_problem(p, a.Q, a.small, s, q);
      if constexpr (TAGGED) k = q;
      ln = DENSE ? max(a.len_s[s], 1) : a.len_s[s];  // the dense block's len_s is raw
      lt = a.len_t[q];
      rstride = (int64_t)a.Tpad * a.Q;
      if constexpr (DENSE)
        base += q + s * (int64_t)a.L * rstride;
      else
        base += (int64_t)q * a.Tpad;  // the query-major [V, Q, Tpad] table
    }
    const int32_t* __restrict__ tok_row =
        (a.tokens != nullptr) ? a.tokens + s * (int64_t)a.L : nullptr;
    // the columns this problem computes (warp-uniform)
    const int T1 = min(lt, a.Tpad) + 1;

    for (int j = lane; j < T1; j += 32) {
      float h0 = 0.0f;
      if (LOC == GLOBAL && j > 0) h0 = -__fmaf_rn((float)j - 1.0f, a.ext_t, a.open_t);
      H[j] = (j <= lt) ? h0 : NEG;
      Fv[j] = NEG;
    }
    __syncwarp();
    float best = (LOC == GLOBAL) ? NEG : 0.0f;
    const int rows = min(ln, a.L);
    int tok = (rows > 0) ? wide_token(tok_row, 0) : 0;
    for (int i = 0; i < rows; ++i) {
      const int dp_i = i + 1;
      const E* __restrict__ src = base + (int64_t)tok * rstride;
      if (i + 1 < rows) tok = wide_token(tok_row, i + 1);
      float init_col = 0.0f;
      if (LOC == GLOBAL) init_col = -__fmaf_rn((float)dp_i - 1.0f, ext_s, open_s);
      // tagged: this row's pos id and the problem's penalty and threshold
      // (warp-uniform), read once a row
      int ps = 0;
      float pen = 0.0f, thr = 0.0f;
      if constexpr (TAGGED) {
        ps = __ldg(t.pos + s * (int64_t)a.L + i);
        pen = __ldg(t.pen + k);
        thr = __ldg(t.thr + k);
      }

      // C (kept in H): diagonal, vertical gap, local floor, boundary column
      float carry = NEG;  // the old H of the previous chunk's last column
      for (int j0 = 0; j0 < T1; j0 += 32) {
        const int j = j0 + lane;
        float h_old = NEG, f_old = NEG, sv = 0.0f;
        if (j < T1) {
          h_old = H[j];
          f_old = Fv[j];
          if constexpr (DENSE) {
            if (j >= 1) sv = __ldg(src + (int64_t)(j - 1) * a.Q);
          } else {
            if (j >= 1) sv = to_f32(__ldg(src + (j - 1)));
          }
          if constexpr (TAGGED) {
            if (j >= 1) {
              const int64_t o = (int64_t)k * t.qs + (j - 1);
              sv = tag_weight(sv, ps, __ldg(t.w + o), __ldg(t.p + o), pen, thr);
            }
          }
        }
        float h_left = __shfl_up_sync(FULL, h_old, 1);
        if (lane == 0) h_left = carry;
        carry = __shfl_sync(FULL, h_old, 31);
        if (j < T1) {
          const float m = (j >= 1 ? h_left + sv : NEG + 0.0f);
          const float f = fmaxf(h_old - open_s, f_old - ext_s);
          float c = fmaxf(m, f);
          if (LOC == LOCAL) c = fmaxf(c, 0.0f);
          if (j == 0) c = init_col;
          Fv[j] = f;
          H[j] = c;
        }
      }
      __syncwarp();
      // Horizontal gap: E = shift_down(C, 1) - open_t, then the decayed
      // prefix max by doubling; shift 1 reads C from H.
      const float d1 = decay * 1.0f;
      for (int j = lane; j < T1; j += 32) {
        const float e = (j >= 1) ? H[j - 1] - open_t : NEG - open_t;
        const float e_left = (j >= 2) ? H[j - 2] - open_t : NEG - open_t;
        EA[j] = (j >= 1) ? fmaxf(e, e_left - d1) : e;
      }
      __syncwarp();
      float* cur = EA;
      float* nxt = EB;
      for (int shift = 2; shift < T1; shift *= 2) {
        const float d = decay * (float)shift;
        for (int j = lane; j < T1; j += 32)
          nxt[j] = (j >= shift) ? fmaxf(cur[j], cur[j - shift] - d) : cur[j];
        __syncwarp();
        float* t = cur;
        cur = nxt;
        nxt = t;
      }
      float colmax = NEG, h_end = NEG;
      for (int j = lane; j < T1; j += 32) {
        const float h = fmaxf(H[j], cur[j]);
        H[j] = h;
        if (j >= 1 && j <= lt) colmax = fmaxf(colmax, h);
        if (j == lt) h_end = h;
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        colmax = fmaxf(colmax, __shfl_xor_sync(FULL, colmax, o));
      h_end = __shfl_sync(FULL, h_end, lt & 31);
      __syncwarp();
      // Every row has dp_i <= len_s.
      if (LOC == LOCAL) {
        best = fmaxf(best, colmax);
      } else if (LOC == GLOBAL) {
        if (dp_i == ln) best = h_end;
      } else {
        best = fmaxf(best, h_end);
        if (dp_i == ln) best = fmaxf(best, colmax);
      }
    }
    if (lane == 0) a.out[p] = (ROWS && a.mask_empty && ln <= 0) ? NEG : best;
    __syncwarp();
  }
}

// Four blocks an SM asked for (up to 64 registers a thread): left to choose,
// ptxas held one scratch template at 40 registers and spilled 16 bytes.
template <int LOC, bool ROWS, bool SCRATCH, typename E>
__global__ void __launch_bounds__(WIDE_THREADS, 4)
    affine_dp_wide_kernel(const Args a, float* __restrict__ scratch) {
  affine_wide_body<LOC, ROWS, SCRATCH, E, false>(a, scratch, TagArgs{});
}

template <int LOC, bool SCRATCH>
__global__ void __launch_bounds__(WIDE_THREADS, 4)
    affine_dp_wide_dense_kernel(const Args a, float* __restrict__ scratch) {
  affine_wide_body<LOC, false, SCRATCH, float, false, true>(a, scratch, TagArgs{});
}

// Three blocks an SM (up to 80 registers a thread): at four, the tagged
// scratch template spilled.
template <int LOC, bool ROWS, bool SCRATCH>
__global__ void __launch_bounds__(WIDE_THREADS, 3)
    affine_dp_wide_tagged_kernel(const Args a, float* __restrict__ scratch,
                                 const TagArgs t) {
  affine_wide_body<LOC, ROWS, SCRATCH, float, true>(a, scratch, t);
}

// ---------------------------------------------------------------------------
// The register-resident wide route ("wide_regs"): needles of 65 up to 32 x
// WIDE_CPL_MAX columns, the default past the register templates
// (ops/dp_kernels.py affine_launch_plan); wider needles keep the route
// above.  Replaces the same TPU kernels as the rest of this file:
// _make_multiq_kernel (:369) / _dp_one_slice (:416) for the gather and
// dense entries, and _make_kernel (:44) for the rows entry, in
// vectorian_tpu/ops/pallas_dp.py.
//
// What bounds it: f32 operations, ~8 + 2 * log2(T1) a cell (the doubling
// steps dominate past 64 columns), against bytes that are the token ids
// and the scores.  The route above spent most of a row on the shared-
// memory protocol instead: the C pass, the E init, every doubling step and
// the final max each read and wrote the rows in shared memory (or device
// scratch) with a __syncwarp between them, ~55 warp-passes a row at T1 =
// 161, and a lane loaded its similarity as one 4-byte scalar.
//
// What the design does about it: one warp a problem, lane l owns the CPL
// contiguous DP columns 1 + l * CPL ... (l + 1) * CPL (CPL = 4, 8 or 16, a
// template parameter: every loop over a lane's columns is unrolled), and H,
// F and E live in registers.  Column 0 is held by every lane as a scalar:
// its H is the boundary value (0, then max(init_col, E[0]) after each row)
// and its E never changes from NEG - open_t.  The lane's similarities are
// columns l * CPL ... of the row, read 4 at a time (16 bytes of f32, 8 of
// bf16, 4 of int8) where a row is contiguous: the query-major gather table,
// the rows entry, a dense block at Q = 1.  The diagonal H[j - 1] is the
// lane's own register, or lane l - 1's last by one __shfl_up_sync.  The
// horizontal gap keeps the reference's doubling, E = max(E, E[j - shift] -
// decay * shift) for shifts 1, 2, 4, ... < T1: a shift below CPL reads the
// lane's own registers (updated in descending order, so each step reads
// only old values) and, for its first ``shift`` registers, those of lane l
// - 1; a shift of m * CPL reads register r of lane l - m, one shuffle a
// register.  A column with no source subtracts +inf (max(E, -inf) is E,
// bit for bit).  No shared memory, no __syncwarp.  The score's maxes
// (local: every row's columns; semiglobal: every row's end column and the
// last row's columns) run per lane, and the warp's xor reduction once a
// problem; the global score's end column comes from the lane that holds
// it, at the last row.  Row i + 1's similarities (and row i + 2's token
// id) are loaded before row i's arithmetic (past 4 columns a lane).
// ``vec`` nonzero allows the 4-element loads.
// ---------------------------------------------------------------------------

constexpr int WIDE_CPL_MAX = 16;
// Blocks of 4 warps: at the 72-91 registers ptxas gives the 8-column
// templates an SM keeps 5-7 of them (20-28 warps), where 8-warp blocks
// kept 2-3 (16-24).
constexpr int WIDE_REGS_WARPS = 4;
constexpr int WIDE_REGS_THREADS = 32 * WIDE_REGS_WARPS;

// Four contiguous table elements as f32, exactly (16 bytes of f32, 8 of
// bf16, 4 of int8).
__device__ __forceinline__ void load4(float* v, const float* p) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(float* v, const uint16_t* p) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}
// int8 by the convert (as to_f32): the register route's byte permute and
// subtract ran this route slower (PERF.md)
__device__ __forceinline__ void load4(float* v, const int8_t* p) {
  const uint32_t x = (uint32_t)__ldg(reinterpret_cast<const int*>(p));
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = (float)(int8_t)(uint8_t)(x >> (8 * k));
}

// Similarity columns c0 ... c0 + CPL - 1 of a row (0 past Tpad); ``vec``:
// 4 at a time (Tpad % 4 == 0, rows aligned to 4 elements, cs == 1).
template <int CPL, typename E>
__device__ __forceinline__ void wide_row(float (&v)[CPL], const E* __restrict__ src,
                                         int c0, int Tpad, int64_t cs, bool vec) {
  if (vec) {
#pragma unroll
    for (int g = 0; g < CPL; g += 4) {
      if (c0 + g < Tpad) {
        load4(&v[g], src + c0 + g);
      } else {
        v[g] = v[g + 1] = v[g + 2] = v[g + 3] = 0.0f;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < CPL; ++r)
      v[r] = (c0 + r < Tpad) ? to_f32(__ldg(src + (int64_t)(c0 + r) * cs)) : 0.0f;
  }
}

// The doubling steps SHIFT, 2 * SHIFT, ... < T1 of a row held as CPL
// registers a lane (columns 1 + lane * CPL + r); ``e0`` is E[0].  One
// instantiation a step, so every register index is a constant.  A column
// with no source (j < SHIFT) subtracts +inf from whatever its shuffle
// brought (a lane with none to its left gets its own value back): max(E,
// -inf) leaves E as it is, bit for bit, with no select a register.
template <int CPL, int SHIFT>
__device__ __forceinline__ void wide_doubling(float (&E)[CPL], float decay, float e0,
                                              int T1, int lane) {
  if constexpr (SHIFT < 32 * CPL) {
    if (SHIFT >= T1) return;  // warp-uniform
    const float d = decay * (float)SHIFT;
    const float pinf = __uint_as_float(0x7f800000u);
    if constexpr (SHIFT < CPL) {
      // registers r < SHIFT read lane l - 1's register CPL - SHIFT + r;
      // lane 0's register SHIFT - 1 reads column 0, its others nothing
      const float dl = (lane >= 1) ? d : pinf;
      float src[SHIFT];
#pragma unroll
      for (int r = 0; r < SHIFT; ++r) src[r] = __shfl_up_sync(FULL, E[CPL - SHIFT + r], 1);
      if (lane == 0) src[SHIFT - 1] = e0;
#pragma unroll
      for (int r = CPL - 1; r >= SHIFT; --r) E[r] = fmaxf(E[r], E[r - SHIFT] - d);
#pragma unroll
      for (int r = 0; r < SHIFT - 1; ++r) E[r] = fmaxf(E[r], src[r] - dl);
      E[SHIFT - 1] = fmaxf(E[SHIFT - 1], src[SHIFT - 1] - d);
    } else {
      // register r of lane l - M; lane M - 1's last register reads column 0
      constexpr int M = SHIFT / CPL;
      const float dl = (lane >= M) ? d : pinf;
#pragma unroll
      for (int r = 0; r < CPL - 1; ++r)
        E[r] = fmaxf(E[r], __shfl_up_sync(FULL, E[r], M) - dl);
      const float o = __shfl_up_sync(FULL, E[CPL - 1], M);
      const bool at0 = lane == M - 1;
      E[CPL - 1] = fmaxf(E[CPL - 1], (at0 ? e0 : o) - (at0 ? d : dl));
    }
    wide_doubling<CPL, 2 * SHIFT>(E, decay, e0, T1, lane);
  }
}

template <int CPL, int LOC, bool ROWS, typename E, bool TAGGED, bool DENSE = false>
__device__ __forceinline__ void affine_wide_regs_body(const Args a, const TagArgs t,
                                                      const int vec_ok) {
  static_assert(!ROWS || std::is_same<E, float>::value, "rows read f32 tables");
  static_assert(!TAGGED || std::is_same<E, float>::value, "tags weight f32 tables");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = lane * CPL;  // the lane's first similarity column
  const int Tpad = a.Tpad;
  const float open_s = a.open_s, ext_s = a.ext_s, open_t = a.open_t;
  const float decay = fminf(a.open_t, a.ext_t);
  const float e0 = NEG - open_t;  // E[0]: no doubling step changes it
  const bool vec = vec_ok != 0;
  const int64_t problems = a.n * (int64_t)a.Q;

  for (int64_t p = (int64_t)blockIdx.x * WIDE_REGS_WARPS + warp; p < problems;
       p += (int64_t)gridDim.x * WIDE_REGS_WARPS) {
    int64_t s, po;  // po: the problem's output
    int ln, lt;
    int k = 0;  // tagged: the query or table slot
    const E* base = static_cast<const E*>(a.table);
    int64_t rstride, cs;
    if (ROWS) {
      s = (a.prow != nullptr) ? (int64_t)a.prow[p] : p;
      po = p;
      ln = a.len_s[p];
      lt = a.len_t[p];
      rstride = Tpad;
      cs = 1;
      base += (a.pslot != nullptr ? (int64_t)a.pslot[p] * a.V : 0) * rstride;
      if (a.tokens == nullptr) base += s * (int64_t)a.L * rstride;
      if constexpr (TAGGED) k = (a.pslot != nullptr) ? a.pslot[p] : 0;
    } else {
      int q;
      split_problem(p, a.Q, a.small, s, q);
      po = s * a.Q + q;
      if constexpr (TAGGED) k = q;
      ln = DENSE ? max(a.len_s[s], 1) : a.len_s[s];  // the dense block's len_s is raw
      lt = a.len_t[q];
      rstride = (int64_t)Tpad * a.Q;
      if constexpr (DENSE) {
        base += q + s * (int64_t)a.L * rstride;
        cs = a.Q;
      } else {
        base += (int64_t)q * Tpad;  // the query-major [V, Q, Tpad] table
        cs = 1;
      }
    }
    const int32_t* __restrict__ tok_row =
        (a.tokens != nullptr) ? a.tokens + s * (int64_t)a.L : nullptr;
    const int T1 = min(lt, Tpad) + 1;  // the columns that reach the score

    float H[CPL], Fv[CPL];
#pragma unroll
    for (int r = 0; r < CPL; ++r) {
      const int j = c0 + 1 + r;
      float h0 = 0.0f;
      if (LOC == GLOBAL) h0 = -__fmaf_rn((float)j - 1.0f, a.ext_t, a.open_t);
      H[r] = (j <= lt) ? h0 : NEG;
      Fv[r] = NEG;
    }
    float h0col = 0.0f;  // H[0]
    float best = (LOC == GLOBAL) ? NEG : 0.0f;
    // the lane that holds column lt (lt == 0: column 0, every lane's)
    const int end_lane = (lt >= 1) ? (lt - 1) / CPL : 0;
    // this lane's part of the score: local, the max of every row's columns
    // 1..lt; semiglobal, of every row's column lt and the last row's
    // columns 1..lt.  The warp reduces it once, after the last row (max is
    // exact in any order).
    float acc = NEG;
    float pen = 0.0f, thr = 0.0f;
    if constexpr (TAGGED) {
      pen = __ldg(t.pen + k);
      thr = __ldg(t.thr + k);
    }
    const int rows = min(ln, a.L);
    // Past 4 columns a lane, row i + 1's similarities load before row i's
    // arithmetic; at 4, ptxas held the global templates at 64 registers
    // and spilled with the second buffer, so they load as they go, the
    // token id a row ahead.
    constexpr bool PREFETCH = CPL > 4;
    float v[CPL];
    int tok_next = 0;
    if (rows > 0) {
      if (PREFETCH)
        wide_row<CPL>(v, base + (int64_t)wide_token(tok_row, 0) * rstride, c0, Tpad, cs, vec);
      else
        tok_next = wide_token(tok_row, 0);
      if (PREFETCH && rows > 1) tok_next = wide_token(tok_row, 1);
    }
    for (int i = 0; i < rows; ++i) {
      const int dp_i = i + 1;
      float vn[CPL];
      if (!PREFETCH) {
        wide_row<CPL>(v, base + (int64_t)tok_next * rstride, c0, Tpad, cs, vec);
        if (i + 1 < rows) tok_next = wide_token(tok_row, i + 1);
      } else if (i + 1 < rows) {
        wide_row<CPL>(vn, base + (int64_t)tok_next * rstride, c0, Tpad, cs, vec);
        if (i + 2 < rows) tok_next = wide_token(tok_row, i + 2);
      }
      if constexpr (TAGGED) {
        const int ps = __ldg(t.pos + s * (int64_t)a.L + i);
#pragma unroll
        for (int r = 0; r < CPL; ++r) {
          if (c0 + r < Tpad) {
            const int64_t ow = (int64_t)k * t.qs + (c0 + r);
            v[r] = tag_weight(v[r], ps, __ldg(t.w + ow), __ldg(t.p + ow), pen, thr);
          }
        }
      }
      float init_col = 0.0f;
      if (LOC == GLOBAL) init_col = -__fmaf_rn((float)dp_i - 1.0f, ext_s, open_s);

      // C (kept in H): diagonal, vertical gap, local floor.  Descending r
      // reads H[r - 1] of the previous row before it is replaced; register
      // 0's diagonal is lane l - 1's last column (lane 0: column 0).
      const float h_up = __shfl_up_sync(FULL, H[CPL - 1], 1);
      const float h_left = (lane == 0) ? h0col : h_up;
#pragma unroll
      for (int r = CPL - 1; r >= 0; --r) {
        const float m = ((r >= 1) ? H[r - 1] : h_left) + v[r];
        const float f = fmaxf(H[r] - open_s, Fv[r] - ext_s);
        float c = fmaxf(m, f);
        if (LOC == LOCAL) c = fmaxf(c, 0.0f);
        Fv[r] = f;
        H[r] = c;
      }
      // Horizontal gap: E = shift_down(C, 1) - open_t (column 1 reads C[0]
      // = init_col), then the decayed prefix max by doubling.
      const float c_up = __shfl_up_sync(FULL, H[CPL - 1], 1);
      float Ev[CPL];
#pragma unroll
      for (int r = CPL - 1; r >= 1; --r) Ev[r] = H[r - 1] - open_t;
      Ev[0] = ((lane == 0) ? init_col : c_up) - open_t;
      wide_doubling<CPL, 1>(Ev, decay, e0, T1, lane);
      float colmax = NEG, h_end = NEG;  // this lane's columns
#pragma unroll
      for (int r = 0; r < CPL; ++r) {
        const int j = c0 + 1 + r;
        const float h = fmaxf(H[r], Ev[r]);
        H[r] = h;
        if (j <= lt) colmax = fmaxf(colmax, h);
        if (j == lt) h_end = h;
      }
      h0col = fmaxf(init_col, e0);
      if (lt == 0) h_end = h0col;
      // Every row has dp_i <= len_s.
      if (LOC == LOCAL) {
        acc = fmaxf(acc, colmax);
      } else if (LOC == GLOBAL) {
        if (dp_i == ln) best = __shfl_sync(FULL, h_end, end_lane);
      } else {
        acc = fmaxf(acc, h_end);
        if (dp_i == ln) acc = fmaxf(acc, colmax);
      }
      if (PREFETCH && i + 1 < rows) {
#pragma unroll
        for (int r = 0; r < CPL; ++r) v[r] = vn[r];
      }
    }
    if (LOC != GLOBAL) {
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1) acc = fmaxf(acc, __shfl_xor_sync(FULL, acc, w));
      best = fmaxf(best, acc);
    }
    if (lane == 0) a.out[po] = (ROWS && a.mask_empty && ln <= 0) ? NEG : best;
  }
}

// Blocks an SM each template is built for: left to choose, ptxas held
// some templates at an occupancy step (64, 96 or 128 registers) and
// spilled 4 bytes; these bounds leave it room above the registers the
// templates take (56-80 at 4 columns a lane, 80-128 at 8, 128-255 at 16).
template <int CPL>
constexpr int wide_regs_min_blocks() {
  return CPL >= 16 ? 2 : 4;
}

template <int CPL, int LOC, bool ROWS, typename E>
__global__ void __launch_bounds__(WIDE_REGS_THREADS, wide_regs_min_blocks<CPL>())
    affine_dp_wide_regs_kernel(const Args a, const int vec) {
  affine_wide_regs_body<CPL, LOC, ROWS, E, false>(a, TagArgs{}, vec);
}

template <int CPL, int LOC, bool ROWS>
__global__ void __launch_bounds__(WIDE_REGS_THREADS, wide_regs_min_blocks<CPL>())
    affine_dp_wide_regs_tagged_kernel(const Args a, const TagArgs t, const int vec) {
  affine_wide_regs_body<CPL, LOC, ROWS, float, true>(a, t, vec);
}

template <int CPL, int LOC>
__global__ void __launch_bounds__(WIDE_REGS_THREADS, wide_regs_min_blocks<CPL>())
    affine_dp_wide_regs_dense_kernel(const Args a, const int vec) {
  affine_wide_regs_body<CPL, LOC, false, float, false, true>(a, TagArgs{}, vec);
}

// The same kernel with four blocks an SM asked for: the quantized gather
// templates at T1P = 17.  With f32 row buffers ptxas, left to itself, kept a
// fifth block there (96 registers) and spilled (bf16, semiglobal).  The
// packed rows no longer spill without the bound, but ptxas's own choice then
// ran the int8 templates slower on the card, so the bound stays.  A bound on
// every template would change the registers ptxas picks for all of them.
template <int T1P, int LOC, bool ROWS, bool VEC, typename E>
__global__ void __launch_bounds__(THREADS, 4) affine_dp_kernel_4b(const Args a) {
  affine_dp_body<T1P, LOC, ROWS, VEC, E, false>(a, TagArgs{});
}

// ``t`` non-null: the tagged kernel (f32 tables only; the entries check).
// DENSE: the dense entry's family.
template <int T1P, int LOC, bool ROWS, bool VEC, typename E, bool DENSE>
void launch_one(dim3 grid, cudaStream_t stream, const Args& a, const TagArgs* t) {
  if constexpr (DENSE) {
    affine_dp_dense_kernel<T1P, LOC, VEC><<<grid, THREADS, 0, stream>>>(a);
  } else {
    if constexpr (std::is_same<E, float>::value) {
      if (t != nullptr) {
        if constexpr (T1P == 17)
          affine_dp_tagged_kernel_4b<T1P, LOC, ROWS, VEC><<<grid, THREADS, 0, stream>>>(a, *t);
        else if constexpr (T1P == 9 && LOC == LOCAL && !ROWS)
          affine_dp_tagged_kernel_6b<T1P, LOC, ROWS, VEC><<<grid, THREADS, 0, stream>>>(a, *t);
        else
          affine_dp_tagged_kernel<T1P, LOC, ROWS, VEC><<<grid, THREADS, 0, stream>>>(a, *t);
        return;
      }
    }
    if constexpr (T1P == 17 && !std::is_same<E, float>::value)
      affine_dp_kernel_4b<T1P, LOC, ROWS, VEC, E><<<grid, THREADS, 0, stream>>>(a);
    else
      affine_dp_kernel<T1P, LOC, ROWS, VEC, E><<<grid, THREADS, 0, stream>>>(a);
  }
}

template <int T1P, bool ROWS, bool VEC, typename E, bool DENSE>
void launch(int locality, dim3 grid, cudaStream_t stream, const Args& a,
            const TagArgs* t) {
  switch (locality) {
    case LOCAL: launch_one<T1P, LOCAL, ROWS, VEC, E, DENSE>(grid, stream, a, t); break;
    case GLOBAL: launch_one<T1P, GLOBAL, ROWS, VEC, E, DENSE>(grid, stream, a, t); break;
    default: launch_one<T1P, SEMIGLOBAL, ROWS, VEC, E, DENSE>(grid, stream, a, t); break;
  }
}

template <int T1P, bool ROWS, typename E, bool DENSE>
void launch_vec(bool vec, int locality, dim3 grid, cudaStream_t stream,
                const Args& a, const TagArgs* t) {
  // the dense entry's strided rows past 32 columns take the wide route
  // (dispatch); only its float4 rows (Q = 1) have T1P = 65 templates
  if constexpr (DENSE && T1P == 65) {
    launch<T1P, ROWS, true, E, DENSE>(locality, grid, stream, a, t);
  } else {
    // quantized rows always load packed (dispatch checks they can)
    if (vec || !std::is_same<E, float>::value) {
      launch<T1P, ROWS, true, E, DENSE>(locality, grid, stream, a, t);
      return;
    }
    if constexpr (std::is_same<E, float>::value)
      launch<T1P, ROWS, false, E, DENSE>(locality, grid, stream, a, t);
  }
}

// A launch on a wide route: its grid, and either the register-resident
// body's columns a lane (cpl > 0) or the shared bytes a block (0 when the
// rows live in ``scratch``); blocks == 0 is the register route.
struct Wide {
  int blocks;
  int cpl;
  int smem;
  float* scratch;
  int vec;  // the register-resident body's 4-element loads (launch_wide_regs)
};

// Shared bytes past the default 48 KB a block must be asked for.
template <typename K>
int allow_smem(K kern, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
}

template <int LOC, bool ROWS, bool SCRATCH, typename E, bool DENSE>
int launch_wide_one(const Wide& w, cudaStream_t st, const Args& a, const TagArgs* t) {
  if constexpr (DENSE) {
    auto kern = affine_dp_wide_dense_kernel<LOC, SCRATCH>;
    if (const int e = allow_smem(kern, w.smem)) return e;
    kern<<<w.blocks, WIDE_THREADS, w.smem, st>>>(a, w.scratch);
    return (int)cudaGetLastError();
  } else {
    if constexpr (std::is_same<E, float>::value) {
      if (t != nullptr) {
        auto kern = affine_dp_wide_tagged_kernel<LOC, ROWS, SCRATCH>;
        if (const int e = allow_smem(kern, w.smem)) return e;
        kern<<<w.blocks, WIDE_THREADS, w.smem, st>>>(a, w.scratch, *t);
        return (int)cudaGetLastError();
      }
    }
    auto kern = affine_dp_wide_kernel<LOC, ROWS, SCRATCH, E>;
    if (const int e = allow_smem(kern, w.smem)) return e;
    kern<<<w.blocks, WIDE_THREADS, w.smem, st>>>(a, w.scratch);
    return (int)cudaGetLastError();
  }
}

template <bool ROWS, typename E, bool DENSE>
int launch_wide(int locality, const Wide& w, cudaStream_t st, const Args& a,
                const TagArgs* t) {
  // the rows live in exactly one place: shared memory or the scratch buffer
  if ((w.scratch == nullptr) != (w.smem > 0) || w.smem < 0) return -1;
  if (w.scratch != nullptr) {
    switch (locality) {
      case LOCAL: return launch_wide_one<LOCAL, ROWS, true, E, DENSE>(w, st, a, t);
      case GLOBAL: return launch_wide_one<GLOBAL, ROWS, true, E, DENSE>(w, st, a, t);
      default: return launch_wide_one<SEMIGLOBAL, ROWS, true, E, DENSE>(w, st, a, t);
    }
  }
  switch (locality) {
    case LOCAL: return launch_wide_one<LOCAL, ROWS, false, E, DENSE>(w, st, a, t);
    case GLOBAL: return launch_wide_one<GLOBAL, ROWS, false, E, DENSE>(w, st, a, t);
    default: return launch_wide_one<SEMIGLOBAL, ROWS, false, E, DENSE>(w, st, a, t);
  }
}

template <int CPL, int LOC, bool ROWS, typename E, bool DENSE>
int launch_wide_regs_one(const Wide& w, cudaStream_t st, const Args& a, const TagArgs* t) {
  if constexpr (DENSE) {
    affine_dp_wide_regs_dense_kernel<CPL, LOC><<<w.blocks, WIDE_REGS_THREADS, 0, st>>>(a, w.vec);
  } else {
    if constexpr (std::is_same<E, float>::value) {
      if (t != nullptr) {
        affine_dp_wide_regs_tagged_kernel<CPL, LOC, ROWS>
            <<<w.blocks, WIDE_REGS_THREADS, 0, st>>>(a, *t, w.vec);
        return (int)cudaGetLastError();
      }
    }
    affine_dp_wide_regs_kernel<CPL, LOC, ROWS, E><<<w.blocks, WIDE_REGS_THREADS, 0, st>>>(a, w.vec);
  }
  return (int)cudaGetLastError();
}

template <int CPL, bool ROWS, typename E, bool DENSE>
int launch_wide_regs_cpl(int locality, const Wide& w, cudaStream_t st, const Args& a,
                         const TagArgs* t) {
  switch (locality) {
    case LOCAL: return launch_wide_regs_one<CPL, LOCAL, ROWS, E, DENSE>(w, st, a, t);
    case GLOBAL: return launch_wide_regs_one<CPL, GLOBAL, ROWS, E, DENSE>(w, st, a, t);
    default: return launch_wide_regs_one<CPL, SEMIGLOBAL, ROWS, E, DENSE>(w, st, a, t);
  }
}

// The register-resident wide body: a lane's CPL columns must hold the
// needle (Tpad <= 32 * CPL); the 4-element loads need contiguous rows
// aligned to 4 elements.
template <bool ROWS, typename E, bool DENSE>
int launch_wide_regs(int locality, Wide w, cudaStream_t st, const Args& a,
                     const TagArgs* t) {
  if (w.smem != 0 || w.scratch != nullptr || a.Tpad > 32 * w.cpl) return -1;
  w.vec = (!DENSE || a.Q == 1) && a.Tpad % 4 == 0 &&
               reinterpret_cast<uintptr_t>(a.table) % (4 * sizeof(E)) == 0;
  switch (w.cpl) {
    case 4: return launch_wide_regs_cpl<4, ROWS, E, DENSE>(locality, w, st, a, t);
    case 8: return launch_wide_regs_cpl<8, ROWS, E, DENSE>(locality, w, st, a, t);
    case WIDE_CPL_MAX: return launch_wide_regs_cpl<WIDE_CPL_MAX, ROWS, E, DENSE>(locality, w, st, a, t);
    default: return -1;
  }
}

template <bool ROWS, typename E, bool DENSE = false>
int dispatch(Args a, int locality, const Wide& w, const TagArgs* t, void* stream) {
  if (a.n <= 0 || a.L <= 0 || a.Q <= 0 || a.Tpad <= 0 || locality < 0 ||
      locality > 2)
    return -1;
  const int64_t problems = a.n * (int64_t)a.Q;
  const int64_t blocks = (problems + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  a.small = problems <= 0xffffffffLL;
  if (w.blocks > 0 && w.cpl > 0) return launch_wide_regs<ROWS, E, DENSE>(locality, w, st, a, t);
  if (w.blocks > 0) return launch_wide<ROWS, E, DENSE>(locality, w, st, a, t);
  // the register route's templates end at T1P = 65 (its plan never sends
  // a wider needle: the wide route takes those)
  if (a.Tpad > 64) return -1;
  dim3 grid((unsigned)blocks);
  // a row's Tpad floats are contiguous (rows, or a gather at Q = 1): float4
  // loads when they stay 16-byte aligned
  const bool vec = (ROWS || a.Q == 1) && a.Tpad % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.table) % 16 == 0;
  // a quantized table's rows load packed, 8 columns a load: whole chunks,
  // aligned (the wrapper pads and copies the query-major table so)
  if (!std::is_same<E, float>::value &&
      (a.Tpad % 8 != 0 || reinterpret_cast<uintptr_t>(a.table) % 16 != 0))
    return -1;
  // the dense entry's T1P = 65 templates read float4 rows only (strided
  // rows of 65 columns spilled 448-460 bytes): AFFINE_DENSE_REG_MAX_T
  if (DENSE && a.Tpad > 32 && !vec) return -1;
  if (a.Tpad <= 8)
    launch_vec<9, ROWS, E, DENSE>(vec, locality, grid, st, a, t);
  else if (a.Tpad <= 16)
    launch_vec<17, ROWS, E, DENSE>(vec, locality, grid, st, a, t);
  else if (a.Tpad <= 32)
    launch_vec<33, ROWS, E, DENSE>(vec, locality, grid, st, a, t);
  else
    launch_vec<65, ROWS, E, DENSE>(vec, locality, grid, st, a, t);
  return (int)cudaGetLastError();
}

template <int LT, int G>
int launch_dense_lanes(int locality, int blocks, cudaStream_t st, const Args& a) {
  switch (locality) {
    case LOCAL: affine_dp_dense_lanes_kernel<LT, G, LOCAL><<<blocks, THREADS, 0, st>>>(a); break;
    case GLOBAL: affine_dp_dense_lanes_kernel<LT, G, GLOBAL><<<blocks, THREADS, 0, st>>>(a); break;
    default: affine_dp_dense_lanes_kernel<LT, G, SEMIGLOBAL><<<blocks, THREADS, 0, st>>>(a); break;
  }
  return (int)cudaGetLastError();
}

template <int LT>
int dense_lanes_width(int locality, int blocks, cudaStream_t st, const Args& a) {
  if (a.Tpad <= 8) return launch_dense_lanes<LT, 8>(locality, blocks, st, a);
  if (a.Tpad <= 16) return launch_dense_lanes<LT, 16>(locality, blocks, st, a);
  return launch_dense_lanes<LT, 32>(locality, blocks, st, a);
}

// Whether a launch can take the tag-weighted block ``t``: every array
// given, the weight table's rows 16-byte aligned.
bool tag_ok(const TagArgs& t) {
  return t.pos != nullptr && t.w != nullptr && t.p != nullptr && t.pen != nullptr &&
         t.thr != nullptr && t.wt != nullptr && t.rmap != nullptr &&
         reinterpret_cast<uintptr_t>(t.wt) % 16 == 0 && t.wr % 4 == 0 && t.wq % 4 == 0;
}

}  // namespace

// Both entries return the cudaError_t of the launch (0 on success), or -1
// when the arguments are outside what the kernel takes.  ``tag``: a host
// pointer to the tag-weighted block's inputs (copied into the launch), or
// null; only an f32 table with token ids takes it.  ``wide_blocks`` > 0
// launches a wide route on that grid: with ``wide_cpl`` > 0 (4, 8 or
// WIDE_CPL_MAX columns a lane, 32 * wide_cpl >= Tpad) the register-resident
// body, else the rows in ``wide_smem`` shared bytes a block or, where that
// is 0, in ``scratch`` (4 x (Tpad + 1) floats a warp, WIDE_WARPS warps a
// block); 0 launches the register route.

// ``table`` of ``table_dtype`` (TableDtype: f32, bf16 bits or int8) is
// [V, Tpad, Q] on the register route and query-major [V, Q, Tpad] on the
// wide routes.
extern "C" int vt_affine_dp_scores(
    const void* table, int table_dtype, const int32_t* tokens,
    const int32_t* len_s, const int32_t* len_t, float* out, int64_t n, int L,
    int Tpad, int Q, float open_s, float ext_s, float open_t, float ext_t,
    int locality, int wide_blocks, int wide_cpl, int wide_smem, float* scratch,
    const TagArgs* tag, void* stream) {
  if (tokens == nullptr) return -1;
  if (tag != nullptr && (table_dtype != F32 || !tag_ok(*tag))) return -1;
  const Args a{table, tokens, nullptr, nullptr, len_s, len_t, out, n, L,
               Tpad, Q, 0, open_s, ext_s, open_t, ext_t, false, false};
  const Wide w{wide_blocks, wide_cpl, wide_smem, scratch, 0};
  switch (table_dtype) {
    case F32: return dispatch<false, float>(a, locality, w, tag, stream);
    case BF16: return dispatch<false, uint16_t>(a, locality, w, nullptr, stream);
    case INT8: return dispatch<false, int8_t>(a, locality, w, nullptr, stream);
    default: return -1;
  }
}

// ``table`` [slots * V, Tmax]; ``tokens`` [n, L] or null (the table is S,
// [B * L, Tmax]); ``rows`` / ``qslot`` [B] or null (b / 0); ``mask_empty``
// nonzero: a problem with len_s <= 0 scores -1e30; ``tag``'s pos rows
// index like ``tokens``, its slots like ``qslot``.
extern "C" int vt_affine_dp_scores_rows(
    const float* table, const int32_t* tokens, const int32_t* rows,
    const int32_t* qslot, const int32_t* len_s, const int32_t* len_t,
    float* out, int64_t B, int L, int Tmax, int64_t V, float open_s,
    float ext_s, float open_t, float ext_t, int locality, int mask_empty,
    int wide_blocks, int wide_cpl, int wide_smem, float* scratch,
    const TagArgs* tag, void* stream) {
  if (tag != nullptr && (tokens == nullptr || !tag_ok(*tag))) return -1;
  const Args a{table, tokens, rows, qslot, len_s, len_t, out, B, L, Tmax, 1,
               V, open_s, ext_s, open_t, ext_t, false, mask_empty != 0};
  const Wide w{wide_blocks, wide_cpl, wide_smem, scratch, 0};
  return dispatch<true, float>(a, locality, w, tag, stream);
}

// ``S`` is the dense [c, L, Tpad, Q] f32 block on both routes (row i of
// slice s at (s * L + i) * Tpad * Q, column j of query q at j * Q + q);
// ``len_s`` [c] (raw: every dense kernel clamps it to >= 1); ``len_t`` [Q].
extern "C" int vt_affine_dp_scores_dense(
    const float* S, const int32_t* len_s, const int32_t* len_t, float* out,
    int64_t c, int L, int Tpad, int Q, float open_s, float ext_s, float open_t,
    float ext_t, int locality, int wide_blocks, int wide_cpl, int wide_smem,
    float* scratch, void* stream) {
  if (S == nullptr) return -1;
  const Args a{S, nullptr, nullptr, nullptr, len_s, len_t, out, c, L,
               Tpad, Q, 0, open_s, ext_s, open_t, ext_t, false, false};
  const Wide w{wide_blocks, wide_cpl, wide_smem, scratch, 0};
  return dispatch<false, float, true>(a, locality, w, nullptr, stream);
}

// The dense entry's lane route ("dense_lanes": L <= 32, Tpad <= 32;
// ``blocks`` of THREADS threads, G = the power of two >= Tpad (at least 8)
// lanes a problem); arguments as in vt_affine_dp_scores_dense.
extern "C" int vt_affine_dp_scores_dense_lanes(
    const float* S, const int32_t* len_s, const int32_t* len_t, float* out,
    int64_t c, int L, int Tpad, int Q, float open_s, float ext_s, float open_t,
    float ext_t, int locality, int blocks, void* stream) {
  if (S == nullptr || c <= 0 || Q <= 0 || L <= 0 || L > 32 || Tpad <= 0 || Tpad > 32 ||
      locality < 0 || locality > 2 || blocks <= 0)
    return -1;
  Args a{S, nullptr, nullptr, nullptr, len_s, len_t, out, c, L,
         Tpad, Q, 0, open_s, ext_s, open_t, ext_t, false, false};
  const int64_t problems = c * (int64_t)Q;
  const int G = Tpad <= 8 ? 8 : Tpad <= 16 ? 16 : 32;
  if ((int64_t)blocks * (THREADS / G) < problems) return -1;
  a.small = problems <= 0xffffffffLL;
  cudaStream_t st = (cudaStream_t)stream;
  if (L <= 8) return dense_lanes_width<8>(locality, blocks, st, a);
  if (L <= 16) return dense_lanes_width<16>(locality, blocks, st, a);
  return dense_lanes_width<32>(locality, blocks, st, a);
}
