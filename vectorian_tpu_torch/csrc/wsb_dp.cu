// Waterman-Smith-Beyer (general gap cost) alignment DP scores, three entries:
//   gather: raw[s, q] = best cell of the DP of slice s against query q, where
//           S[i, j] = table[tokens[s, i], j, q] (the gather is fused in); the
//           table is f32, bf16 or int8 (a quantized ranking table: each
//           element becomes f32 right after its load, exactly);
//   rows:   raw[b] = best cell of the DP of problem b = (bucket row r =
//           rows[b], table slot k = qslot[b]), where S[i, j] =
//           table[k * V + tokens[r, i], j] (the stacked [slots * V, Tmax]
//           plan table, read row by row), per-problem len_s (0 allowed) and
//           len_t; the score-only rescore.  A null ``tokens`` reads the
//           table itself as S ([B * L, T]: row r * L + i), the flat batch;
//   dense:  raw[s, q] as in the gather entry, where S[i, j] = S[s, i, j, q]
//           of a dense [c, L, T, Q] f32 block (a contextual chunk's metric
//           GEMM output, query minor), read in place: the gather entry
//           with slice s's row i at "token id" s * L + i.  On the register
//           route lane k reads column k of its row Q floats apart (the
//           gather entry reads a transposed [V, Q, T] copy there; the dense
//           block is not copied).
// H[i, j] = max(H[i-1, j-1] + S[i-1, j-1], max_g H[i-g, j] - w_s[g],
//               max_g H[i, j-g] - w_t[g] [, 0 local]).
//
// Replaces: _make_general_kernel / _pallas_call_scores_general /
// pallas_align_scores_general in vectorian_tpu/ops/pallas_dp.py.  On the
// TPU the corpus pass gathered the similarity block in XLA and flattened it
// to [c*Q, L, T] before the kernel, and the rescore gathered its [B, L, T]
// block the same way; here both entries read the tables themselves, so the
// gathered block never reaches device memory.
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
// Five designs, picked per launch by ops/dp_kernels.wsb_launch_plan:
//
// "registers" (bucket capacity L <= 32 and needle width T <= 32, closure
// w_t* >= 0: every corpus pass and rescore of the default buckets up to 32
// tokens).  A group of G lanes (G = 8, 16 or 32, the power of two >= T) is
// one problem; lane k holds needle column k + 1, and column 0 is a closed
// form (0, or -w_s[i] under global).  Each lane keeps its column's history
// H[0..L] in registers: L is a template constant and the row loop is fully
// unrolled (uniform exit at the warp's longest slice), so the vertical
// candidates max_r H[r] - w_s[i - r] have compile-time indices and read
// their cost from the kernel's parameter bank — no shared or local memory,
// no row buffer.  The diagonal is one shuffle up; the horizontal gaps are
// one shuffle per gap length g against w_t*[g] (the exact one-pass form:
// each candidate one rounding), unconditional and branch-free, so the
// shuffles of a row issue back to back (models whose closure has a
// negative cost take the shared / scratch route).  The best cell is a
// per-lane running max, reduced across the group once at the end.  In the
// gather entry q walks fastest, so a warp holds 32 / G consecutive queries
// of one slice (Q >= 32 / G) and its row loop does not diverge; where Q is
// even a group takes two consecutive queries of one slice: their token ids,
// table row addresses and row loop are shared, which takes ~15 of the ~50
// instructions a lane spends a problem-row off one of the two problems.
// Gather table rows are read from a [V, Q, T] layout (the wrapper
// transposes the [V, T, Q] table once per call; the same memory at Q = 1);
// a row-gather problem's row is already contiguous, lane k reading its
// element k.  A row's token id and table value are loaded a row ahead of
// their use.
//
// A bf16 or int8 table (find_batch's quantized ranking pass) stays in its
// own type.  What bounded it: a lane's two queries read their elements of
// a column with two loads a row, each converted after its load (a shift, or
// one int-to-float convert), beside ~50 instructions a problem-row; the
// quantized launch ran within 1% of the f32 one, so its gap to the bound
// is the register route's own (PERF.md).  What the design does about it:
// where Q is even the wrapper hands the kernel a paired copy, [V, Q / 2, T,
// 2] (ops/dp_kernels.wsb_register_table), the two queries' elements of a
// column side by side, so a lane loads both with one 2-byte (int8) or
// 4-byte (bf16) load (wsb_regs_paired_kernel).  An int8 element keeps its
// convert (I2F), which issues on a pipe of its own: the exact integer form
// of csrc/affine_dp.cu takes two issue slots of the f32 maxes and adds that
// bound this route, and ran slower here.
//
// "long" (bucket capacity 33-256, the register route's needles and gap
// models: the buckets of 64, 128 and 256 tokens).  What bounded them on the
// thread-a-problem body below: one thread walks a problem, every vertical
// candidate one load of a stored row (L^2 T / 2 of them a problem), the
// rows in a scratch buffer wherever too few threads fit in shared memory,
// and a few warps an SM each on a chain of dependent steps (20-2,000x the
// bound).  What the design does about it: the register route's lane groups
// (the diagonal one shuffle, the horizontal gaps G - 1 shuffles against
// w_t*, no stored row read for either); each lane keeps its column's
// history in shared memory, and the rows run in blocks of LONG_R: before a
// block, a lane streams its stored rows once, 16 bytes and 4 rows a load,
// into the block's LONG_R vertical accumulators (LONG_R candidates a
// loaded value, LONG_R independent max chains), the costs of a stored
// block read as warp-wide broadcasts; inside the block the candidates of
// its own rows come from registers.  The f32 maxes and subtracts the data
// needs (~2 i a cell) then dominate.  A block's history is (L rounded up
// to LONG_R) floats a thread, so at L 256 six warps an SM fit.  Tag
// weights and closures with a negative cost stay on the body below.
//
// "wide" (needles padded to 33-512 columns, untagged, wherever a warp's
// column history of L x T floats leaves at least 4 warps resident an SM:
// a find or a batch group of long queries against the default buckets).
// What bounded them on the thread-a-problem body below: one thread walks a
// problem whose (L + 1) x (T + 1) rows (11 KB at L 16, T 160) fit only a
// scratch buffer, ~24,500 threads in flight for the card, every vertical
// and horizontal candidate a load of that buffer.  What the design does
// about it: one warp a problem, DP column j = 32c + lane + 1 at lane
// ``lane``, register slot c (CPL slots, a template constant of 2, 4, 8 or
// 16; only the slots the needle reaches run), so a slot's table reads are
// 32 consecutive elements of the query-major [V, Q, T] copy.  The diagonal
// is one shuffle a slot (lane 0 takes lane 31's value of the slot below).
// Vertical gaps: each lane keeps its columns' history in shared memory,
// row r at hist[(r - 1) * T + column], and streams it once a row against
// broadcast costs.  Horizontal gaps (E[j] = max_k C[k] - w_t*[j - k], the
// bulk of the work past 32 columns): the row's C goes to a shared row of
// the warp; each slot walks k up to its last column, four C values a step
// as one broadcast and its four costs w_t*[j - k] from a shared copy at
// consecutive addresses across the warp (no bank conflict).  The copy holds
// +inf where j - k <= 0 or past
// T, so every k may meet every column: one pass, exact for any closure (a
// gap bonus too), no shuffle a candidate.  What bounds it then: one shared
// load a candidate (32 lanes' 4 bytes each, the shared memory's width a
// clock) and a broadcast a four, beside two f32 operations a candidate.
//
// "shared" / "scratch" (buckets past 256, shapes past the wide route's
// shared memory, negative closures at needles of at most 32 columns,
// tagged launches past the register route): one thread
// per problem; the rows of a problem live in shared memory when
// enough threads a block fit there, else in a device scratch buffer the
// wrapper allocates for the threads in flight (the grid then walks over the
// problems).  Both go through one pointer and stride, with the thread index
// fastest, so a warp's row reads are conflict-free (shared) or coalesced
// (scratch); the block size is a template constant, so shared rows take
// 32-bit shared-memory addresses with immediate column offsets.  Columns
// are processed in register tiles of CH: per stored row one uniform cost
// load serves CH candidates, and the next stored row's tile is loaded
// while this one's candidates are maxed in (at the few warps an SM of the
// scratch route, the loop waits on load latency).  Rows stop at the
// slice's length and columns at the needle's (no cell past them can change
// the score), so the work is what the data needs.  Horizontal gaps run in place over the row, highest
// tile first, so every tile reads C values not yet replaced by H.
//
// The dense entry (ops/dp_kernels.wsb_dp_scores_dense) takes the gather
// entry's routes on the [c, L, T, Q] block in place.  What bounds it: a
// contextual batch's chunk (c = 2,048 slices of bucket capacity 16 against
// Q = 32 needles padded to 8) reads ~16.5 MB of the block once, 5.0 us at
// the HBM rate, against ~2.7 us of f32 instructions; a find's chunk (c =
// 8,192, Q = 1) 0.64 us, under the ~2 us any launch takes on the device.
// The lane groups spend ~45 instructions a lane a problem-row whatever the
// needle (G - 1 = 7 horizontal shuffles) and run at ~3x the bytes bound.
// A thread a problem (its 16 x 8 column histories in registers, a warp one
// slice's 32 queries) beat them only where every slice had one length: on
// a bucket's mix of 9-16 tokens it ran 1.04-1.49x their time at 65,536
// problems and more, so the groups stay.  What the design does: every
// dense kernel clamps len_s to >= 1 itself, where the wrapper took a
// launch of its own for it (~2 us of device time), so a call is one launch.
//
// Tag weights (TagArgs; f32 tables only): on every route each S value
// becomes, where it is loaded, the JAX package's tag-weighted value
// (ops/search.py _apply_tag_weights):
//   w = tw_w[q, j] * (pos[s, i] == tw_p[q, j] ? 1 : 1 - pen[q]),
//   S' = S * w > thr[q] ? S * w : 0,
// in that order, each product and difference one rounding (__fmul_rn,
// __fsub_rn).  What bounded the tagged register route (1.1-1.5x the
// untagged one): every row, every lane issued nine loads for it at P = 2
// (the row's pos id and each problem's w, p, pen and thr) where the
// untagged body issues three, under a guard that kept the eight that never
// change within a problem from leaving the row loop, and rebuilt w in every
// cell.  What the design does about it: a lane's column of each problem is
// fixed, so its weights leave the row loop, loaded once a problem — w on a
// row of the needle token's pos id, w * (1 - pen) (the same single
// rounding) on any other, the needle's pos id and the threshold — and the
// row's pos id loads one row ahead with its similarities.  A cell then
// costs a compare, a select, one multiply, a compare and a select, with no
// load; the rewrite runs on every lane and row, since a column past the
// needle or a row past the slice reaches no cell that counts.  The shared /
// scratch route (a thread a problem) reads the weight table the wrapper
// builds once a corpus pass (ops/dp_kernels.tag_table: W[r, q, j], one row
// r for each distinct needle pos id and one for every other, and rmap, the
// row of each of the 256 pos ids): a row looks up its pos id's table row
// once, a tile of CH cells loads its weights from it as two float4 (a
// thread's columns are contiguous) before its vertical gaps, where each
// cell loaded the needle's weight and pos id and rebuilt w (one scalar load
// a cell from the table ran 1.02-1.05x the old design: a warp's 32 threads
// read 32 rows, 8 cache lines a load).
// A gather query q reads column j of the needle's [Q, T] weights at q * qs
// + j, a row-gather problem its slot qslot[b]; pos is [n, L] like the
// tokens.  The tagged kernels are their own template family
// (wsb_dp_tagged_kernel, wsb_regs_tagged_kernel), f32 only, with TagArgs a
// kernel parameter of theirs alone, so the untagged kernels are unchanged
// (as in csrc/affine_dp.cu).
//
// Exactness contract: the DP is adds, subtractions and maxes only, each
// candidate one rounding (Hall - w, H_prev + S), so the scores are bit-equal
// to the JAX reference (pallas_align_scores_general, align_scores_general)
// in any order of the maxes; a quantized element converts to f32 exactly, as
// the reference's cast of the gathered block does.  Built with --fmad=false
// all the same.

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
constexpr int CH = 8;  // columns per register tile
enum Locality { LOCAL = 0, GLOBAL = 1, SEMIGLOBAL = 2 };
// the gather entries' table types (their C entries' ``table_dtype``)
enum TableDtype { F32 = 0, BF16 = 1, INT8 = 2 };

// A table element as f32, exactly: bf16 (its 16 bits) is the high half of
// the f32 with the same value; int8 is an integer of at most 7 bits (its
// convert issues on a pipe of its own; see the header).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t x) {
  return __uint_as_float((uint32_t)x << 16);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// Two consecutive queries' elements of one column, side by side in a
// paired table, as f32, exactly; 0 where not ``ok``.
template <typename E>
__device__ __forceinline__ void load_pair(float (&v)[2], const E* p, bool ok) {
  if constexpr (sizeof(E) == 1) {
    const uint32_t w = ok ? (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) : 0u;
    v[0] = (float)(int8_t)(uint8_t)w;
    v[1] = (float)(int8_t)(uint8_t)(w >> 8);
  } else {
    const uint32_t w = ok ? __ldg(reinterpret_cast<const unsigned int*>(p)) : 0u;
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
}

// One tag-weighted similarity from its weight ``wv`` (w, or w * (1 -
// pen), already rounded): S * w, then the threshold.
__device__ __forceinline__ float tag_apply(float s, float wv, float thr) {
  const float sw = __fmul_rn(s, wv);
  return (sw > thr) ? sw : 0.0f;
}

// The first n of CH columns of a stored row (column u at p[u * cs]); NEG
// past them.
template <typename I>
__device__ __forceinline__ void load_tile(float (&h)[CH], const float* p, I cs, int n) {
#pragma unroll
  for (int u = 0; u < CH; ++u) h[u] = (u < n) ? p[(I)u * cs] : NEG;
}

// The arguments of a launch (every entry and route); passed by value into
// the kernel's parameter bank.
struct Args {
  const void* table;      // gather: [V, T, Q] of E (registers: [V, Q, T]); rows: [slots * V, T] f32
  const int32_t* tokens;  // [n, L]; rows: null = the table is S (row r * L + i)
  const int32_t* prow;    // rows: [B] bucket row of each problem, null = b
  const int32_t* pslot;   // rows: [B] table slot of each problem, null = 0
  const int32_t* len_s;   // gather: [n], >= 1; rows: [B], >= 0
  const int32_t* len_t;   // gather: [Q]; rows: [B]; 0 <= len_t <= T
  const float* w_s;       // [L + 1] raw s-side costs (shared / scratch)
  const float* w_t;       // [T + 1] raw t-side costs (global row 0)
  const float* w_ts;      // [T + 1] closure of w_t
  float* out;             // [problems]
  float* scratch;         // rows in device memory, or null: shared
  int64_t problems;
  int L, T, Q;            // rows: Q = 1
  int64_t V;              // rows: table rows a slot
  bool small;             // problems fit 32 bits
  bool mask_empty;        // rows: len_s <= 0 scores NEG
};

// THREADS > 0: a block of THREADS threads keeps its rows in shared memory;
// THREADS == 0: the rows live in ``scratch`` (one slot per thread of the grid).
// E: the table's element type (float, uint16_t for bf16, int8_t); the
// row-gather entry reads the f32 plan table only.  TAGGED (f32 only): the
// similarities are tag-weighted by ``t``.
// DENSE (gather only): the table is the dense [c, L, T, Q] block.
template <int LOC, bool GATHER, int THREADS, typename E, bool TAGGED,
          bool DENSE = false>
__device__ __forceinline__ void wsb_dp_body(const Args a, const TagArgs t) {
  static_assert(GATHER || std::is_same<E, float>::value, "rows read f32 tables");
  static_assert(!TAGGED || std::is_same<E, float>::value, "tags weight f32 tables");
  // cell (r, j) of this thread's problem at base[r * rs + j * cs]
  using I = typename std::conditional<(THREADS > 0), int, int64_t>::type;
  extern __shared__ float smem[];
  const E* __restrict__ S = static_cast<const E*>(a.table);
  const int32_t* __restrict__ tokens = a.tokens;
  const float* __restrict__ w_s = a.w_s;
  const float* __restrict__ w_t = a.w_t;
  const float* __restrict__ w_ts = a.w_ts;
  const int L = a.L, T = a.T, Q = a.Q;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  float* const base = (THREADS > 0) ? smem + threadIdx.x : a.scratch + tid;
  const I cs = (THREADS > 0) ? (I)THREADS : (I)nthreads;
  const I rs = (I)(T + 1) * cs;
  auto at = [&](int r, int j) -> float& { return base[(I)r * rs + (I)j * cs]; };

  for (int64_t p = tid; p < a.problems; p += nthreads) {
    int64_t s;
    int q, ln, lt;
    const E* tbase;  // rows: row 0 of the problem's table slot
    if (GATHER) {
      s = p / Q;
      q = (int)(p - s * Q);
      ln = DENSE ? max(a.len_s[s], 1) : a.len_s[s];  // the dense block's len_s is raw
      lt = a.len_t[q];
      tbase = S + q;
    } else {
      s = (a.prow != nullptr) ? (int64_t)a.prow[p] : p;
      q = (a.pslot != nullptr) ? a.pslot[p] : 0;
      ln = a.len_s[p];
      lt = a.len_t[p];
      tbase = S + ((int64_t)q * a.V + (tokens != nullptr ? 0 : s * L)) * T;
    }
    float thr = 0.0f;  // tagged: the problem's threshold
    if constexpr (TAGGED) thr = __ldg(t.thr + q);

    for (int j = 0; j <= lt; ++j)
      at(0, j) = (LOC == GLOBAL && j > 0) ? -w_t[j] : 0.0f;
    float best = (LOC == GLOBAL) ? NEG : 0.0f;

    const int rows = min(ln, L);
    for (int i = 1; i <= rows; ++i) {
      // similarity row i - 1: column j - 1 at srow[(j - 1) * scs]
      const E* srow;
      int64_t scs;
      // tagged: the weight-table row of this row's pos id at the problem's
      // query / slot, column j - 1 at wrow[j - 1]
      const float* wrow = nullptr;
      if constexpr (TAGGED) {
        const uint8_t ps = (uint8_t)__ldg(t.pos + s * L + i - 1);
        wrow = t.wt + (int64_t)__ldg(t.rmap + ps) * t.wr + (int64_t)q * t.wq;
      }
      if (GATHER) {
        if constexpr (DENSE)
          srow = tbase + (s * L + i - 1) * (int64_t)T * Q;
        else
          srow = tbase + (int64_t)tokens[s * L + i - 1] * T * Q;
        scs = Q;
      } else {
        srow = tbase + (int64_t)(tokens != nullptr ? tokens[s * L + i - 1] : i - 1) * T;
        scs = 1;
      }

      // C = max(diagonal, vertical gaps[, 0]) into row i, columns 1..lt
      for (int j0 = 1; j0 <= lt; j0 += CH) {
        float v[CH];
#pragma unroll
        for (int u = 0; u < CH; ++u) v[u] = NEG;
        // row r + 1's tile is loaded before row r's is maxed in, so a
        // step's CH loads never wait on its arithmetic (left to itself,
        // ptxas gave the untagged templates 72-80 registers and issued each
        // load just before its use, two in flight: the scratch route ran at
        // half the tagged kernel's speed).  The last step reads row i,
        // not yet written, and never uses it.
        // tagged: the tile's weights, columns j0 - 1 ... j0 + CH - 2 of the
        // table row, 16 bytes at a time (j0 - 1 is a multiple of CH and the
        // rows are 16-byte aligned), in flight while the vertical gaps run
        float wv[CH];
        if constexpr (TAGGED) {
#pragma unroll
          for (int c = 0; c < CH / 4; ++c) {
            float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (j0 - 1 + 4 * c < lt) x = __ldg(reinterpret_cast<const float4*>(wrow + j0 - 1) + c);
            wv[4 * c] = x.x;
            wv[4 * c + 1] = x.y;
            wv[4 * c + 2] = x.z;
            wv[4 * c + 3] = x.w;
          }
        }
        float h[CH];
        float w = w_s[i];
        load_tile(h, &at(0, j0), cs, lt - j0 + 1);
        for (int r = 0; r < i; ++r) {
          float hn[CH];
          const float wn = w_s[i - r - 1];
          load_tile(hn, &at(r + 1, j0), cs, lt - j0 + 1);
#pragma unroll
          for (int u = 0; u < CH; ++u) {
            if (j0 + u <= lt) v[u] = fmaxf(v[u], h[u] - w);
            h[u] = hn[u];
          }
          w = wn;
        }
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const int j = j0 + u;
          if (j <= lt) {
            float sv = to_f32(__ldg(srow + (j - 1) * scs));
            if constexpr (TAGGED) sv = tag_apply(sv, wv[u], thr);
            const float m = at(i - 1, j - 1) + sv;
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
    a.out[p] = (!GATHER && a.mask_empty && ln <= 0) ? NEG : best;
  }
}

template <int LOC, bool GATHER, int THREADS, typename E>
__global__ void __launch_bounds__(128) wsb_dp_kernel(const Args a) {
  wsb_dp_body<LOC, GATHER, THREADS, E, false>(a, TagArgs{});
}

template <int LOC, bool GATHER, int THREADS>
__global__ void __launch_bounds__(128) wsb_dp_tagged_kernel(const Args a, const TagArgs t) {
  wsb_dp_body<LOC, GATHER, THREADS, float, true>(a, t);
}

// The dense entry's shared / scratch route: a family of its own, so the
// gather templates stay as they are.
template <int LOC, int THREADS>
__global__ void __launch_bounds__(128) wsb_dp_dense_kernel(const Args a) {
  wsb_dp_body<LOC, true, THREADS, float, false, true>(a, TagArgs{});
}

// ---------------------------------------------------------------------------
// register route
// ---------------------------------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;
constexpr int REG_THREADS = 128;

// The cost vectors, passed by value: indexed with compile-time constants,
// each cost is an operand from the parameter bank.  Entries past the
// bucket's L + 1 or the needle's T + 1 are zero and never reach a cell that
// counts.
template <int LT, int G>
struct RegCosts {
  float w_s[LT + 1];  // raw s-side costs
  float w_t[G + 1];   // raw t-side costs (global row 0)
  float w_ts[G + 1];  // closure of w_t
};

// The cost vectors on the host, as the entries receive them.
struct HostCosts {
  const float* w_s;  // n_ws floats
  int n_ws;
  const float* w_t;  // T + 1 floats or more
  const float* w_ts;
};

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

// P consecutive problems a group.  Gather (ROWS false): queries q .. q + P
// - 1 of one slice (P = 2 only where Q % 2 == 0), sharing its token ids,
// table row addresses and row loop.  Rows: one problem a group (each has
// its own len_t), its row read from table slot q.  E: the table's element
// type, as in wsb_dp_kernel.
// TAGGED (f32 only): the similarities are tag-weighted by ``t``.
// DENSE (gather only): the table is the dense [c, L, T, Q] block.
// PAIRED (quantized gather, P = 2): the table is [V, Q / 2, T, 2], the two
// queries' elements of a column side by side, one load for both.
template <int LT, int G, int LOC, int P, bool ROWS, typename E, bool TAGGED,
          bool DENSE = false, bool PAIRED = false>
__device__ __forceinline__ void wsb_regs_body(const RegCosts<LT, G> costs, const Args a,
                                              const TagArgs t) {
  static_assert(!ROWS || P == 1, "a row-gather group takes one problem");
  static_assert(!PAIRED || (P == 2 && !ROWS && !DENSE && sizeof(E) <= 2),
                "paired loads are a quantized gather group's two queries");
  static_assert(!ROWS || std::is_same<E, float>::value, "rows read f32 tables");
  static_assert(!TAGGED || std::is_same<E, float>::value, "tags weight f32 tables");
  const int64_t gthread = (int64_t)blockIdx.x * REG_THREADS + threadIdx.x;
  const int k = threadIdx.x & (G - 1);  // this lane's column is j = k + 1
  const int j = k + 1;
  const int64_t p_raw = (gthread / G) * P;
  const bool valid = p_raw < a.problems;
  const int64_t p = valid ? p_raw : 0;  // a tail group computes, stores nothing
  int64_t s;
  int q, ln;
  int lt[P];
  if (ROWS) {
    s = (a.prow != nullptr) ? (int64_t)a.prow[p] : p;
    q = (a.pslot != nullptr) ? a.pslot[p] : 0;
    ln = a.len_s[p];
    lt[0] = a.len_t[p];
  } else {
    split_problem(p, a.Q, a.small, s, q);
    ln = DENSE ? max(a.len_s[s], 1) : a.len_s[s];  // the dense block's len_s is raw
#pragma unroll
    for (int u = 0; u < P; ++u) lt[u] = a.len_t[q + u];
  }
  const int rows = valid ? min(ln, a.L) : 0;
  // uniform bound of the warp: its longest slice
  const int rows_warp = __reduce_max_sync(FULL, rows);

  // this lane's own costs
  float wt_lane = 0.0f, wts_lane = 0.0f;
#pragma unroll
  for (int g = 1; g <= G; ++g) {
    if (j == g) {
      wt_lane = costs.w_t[g];
      wts_lane = costs.w_ts[g];
    }
  }
  // horizontal candidate from column 0 (C[i][0] = 0) outside global
  const float e0 = 0.0f - wts_lane;
  const bool col_in = k < a.T;
  // tagged: this lane's column of each problem's tag weights, out of the
  // row loop — its weight on a row of the needle token's pos id (w) and on
  // any other (w * (1 - pen), rounded as the plain rewrite rounds it), the
  // needle's pos id, the threshold
  float tw_m[P], tw_x[P], tw_thr[P];
  int tw_p[P];
  if constexpr (TAGGED) {
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int64_t o = (int64_t)(q + u) * t.qs + k;
      tw_m[u] = col_in ? __ldg(t.w + o) : 0.0f;
      tw_x[u] = __fmul_rn(tw_m[u], __fsub_rn(1.0f, __ldg(t.pen + q + u)));
      tw_p[u] = col_in ? (int)__ldg(t.p + o) : 0;
      tw_thr[u] = __ldg(t.thr + q + u);
    }
  }

  float hist[P][LT + 1];  // H[r][j] of each problem, r = 0..i
  float acc[P];
  int last[P];  // rows whose cell counts (local)
#pragma unroll
  for (int u = 0; u < P; ++u) {
    hist[u][0] = (LOC == GLOBAL) ? -wt_lane : 0.0f;
    acc[u] = (LOC == GLOBAL) ? NEG : 0.0f;
    last[u] = (j <= lt[u]) ? rows : 0;
  }

  // a row's token id is loaded two rows ahead, its table values one row
  // ahead; table offsets fit 32 bits
  const uint32_t T = (uint32_t)a.T;
  const int32_t* trow = (a.tokens != nullptr) ? a.tokens + s * (int64_t)a.L : nullptr;
  auto tok_at = [&](int i) -> uint32_t {
    return (DENSE || (ROWS && trow == nullptr)) ? (uint32_t)i
                                                : (uint32_t)__ldg(trow + i);
  };
  // between the consecutive queries of a group (P = 2)
  const uint32_t ustride = DENSE ? 1u : T;
  uint32_t vstride, off;
  if constexpr (DENSE) {
    // row i of slice s at (s * L + i) * T * Q, column k of query q at k * Q + q
    vstride = (uint32_t)a.Q * T;
    off = (uint32_t)(s * a.L) * vstride + (uint32_t)q + (uint32_t)k * (uint32_t)a.Q;
  } else if (ROWS) {
    vstride = T;
    off = ((uint32_t)q * (uint32_t)a.V +
           (trow == nullptr ? (uint32_t)(s * a.L) : 0u)) * T + (uint32_t)k;
  } else {
    vstride = (uint32_t)a.Q * T;
    // paired: query q (even) and q + 1's column k side by side at q * T + 2k
    off = (uint32_t)q * T + (uint32_t)k * (PAIRED ? 2u : 1u);
  }
  const E* tcol = static_cast<const E*>(a.table) + off;
  uint32_t tok_n = (rows >= 2) ? tok_at(1) : 0;
  // tagged: the pos id of the row sv_n holds, loaded with it
  const int8_t* pos_row = nullptr;
  int ps_n = 0;
  if constexpr (TAGGED) {
    pos_row = t.pos + s * (int64_t)a.L;
    if (rows >= 1) ps_n = __ldg(pos_row);
  }
  float sv_n[P];
  if constexpr (PAIRED) {
    load_pair(sv_n, tcol + tok_at(0) * vstride, rows >= 1 && col_in);
  } else {
    const E* r0 = tcol + tok_at(0) * vstride;
#pragma unroll
    for (int u = 0; u < P; ++u)
      sv_n[u] = (rows >= 1 && col_in) ? to_f32(__ldg(r0 + u * ustride)) : 0.0f;
  }

#pragma unroll
  for (int i = 1; i <= LT; ++i) {
    if (i > rows_warp) break;
    float sv[P];
#pragma unroll
    for (int u = 0; u < P; ++u) sv[u] = sv_n[u];
    if constexpr (TAGGED) {
      // every lane and row: a column past the needle or a row past the
      // slice reaches no cell that counts
#pragma unroll
      for (int u = 0; u < P; ++u)
        sv[u] = tag_apply(sv[u], (ps_n == tw_p[u]) ? tw_m[u] : tw_x[u], tw_thr[u]);
    }
    if (i < LT) {
      const E* rn = tcol + tok_n * vstride;
      if constexpr (PAIRED) {
        load_pair(sv_n, rn, i + 1 <= rows && col_in);
      } else {
#pragma unroll
        for (int u = 0; u < P; ++u)
          sv_n[u] = (i + 1 <= rows && col_in) ? to_f32(__ldg(rn + u * ustride)) : 0.0f;
      }
      if constexpr (TAGGED) ps_n = (i + 1 <= rows) ? (int)__ldg(pos_row + i) : 0;
      if (i + 1 < LT) tok_n = (i + 2 <= rows) ? tok_at(i + 1) : 0;
    }
    const float h_prev0 = (LOC == GLOBAL && i > 1) ? -costs.w_s[i - 1] : 0.0f;
#pragma unroll
    for (int u = 0; u < P; ++u) {
      // diagonal: H[i - 1][j - 1] + S[i - 1][j - 1]
      const float up = __shfl_up_sync(FULL, hist[u][i - 1], 1, G);
      const float m = ((k == 0) ? h_prev0 : up) + sv[u];
      // vertical gaps over every earlier row of this column
      float v = hist[u][0] - costs.w_s[i];
#pragma unroll
      for (int r = 1; r < i; ++r) v = fmaxf(v, hist[u][r] - costs.w_s[i - r]);
      float c = fmaxf(m, v);
      if (LOC == LOCAL) c = fmaxf(c, 0.0f);
      // horizontal gaps: C[i][j - g] - w_t*[g], and g = j from column 0.  A
      // lane below g gets its own C back: c - w_t*[g] <= c (the wrapper
      // sends only w_t* >= 0 here) never changes max(c, e).
      float e = (LOC == GLOBAL) ? -costs.w_s[i] - wts_lane : e0;
#pragma unroll
      for (int g = 1; g < G; ++g)
        e = fmaxf(e, __shfl_up_sync(FULL, c, g, G) - costs.w_ts[g]);
      const float h = fmaxf(c, e);
      hist[u][i] = h;
      if (LOC == LOCAL) {
        if (i <= last[u]) acc[u] = fmaxf(acc[u], h);
      } else if (LOC == GLOBAL) {
        if (i == ln && j == lt[u]) acc[u] = h;
      } else {
        if (i <= rows && j == lt[u]) acc[u] = fmaxf(acc[u], h);
        if (i == ln && j <= lt[u]) acc[u] = fmaxf(acc[u], h);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < P; ++u) {
#pragma unroll
    for (int off2 = G / 2; off2 > 0; off2 >>= 1)
      acc[u] = fmaxf(acc[u], __shfl_xor_sync(FULL, acc[u], off2, G));
    if (valid && k == 0)
      a.out[p + u] = (ROWS && a.mask_empty && ln <= 0) ? NEG : acc[u];
  }
}

template <int LT, int G, int LOC, int P, bool ROWS, typename E>
__global__ void __launch_bounds__(REG_THREADS) wsb_regs_kernel(
    const RegCosts<LT, G> costs, const Args a) {
  wsb_regs_body<LT, G, LOC, P, ROWS, E, false>(costs, a, TagArgs{});
}

template <int LT, int G, int LOC, int P, bool ROWS>
__global__ void __launch_bounds__(REG_THREADS) wsb_regs_tagged_kernel(
    const RegCosts<LT, G> costs, const Args a, const TagArgs t) {
  wsb_regs_body<LT, G, LOC, P, ROWS, float, true>(costs, a, t);
}

template <int LT, int G, int LOC, typename E>
__global__ void __launch_bounds__(REG_THREADS) wsb_regs_paired_kernel(
    const RegCosts<LT, G> costs, const Args a) {
  wsb_regs_body<LT, G, LOC, 2, false, E, false, false, true>(costs, a, TagArgs{});
}

template <int LT, int G, int LOC, int P>
__global__ void __launch_bounds__(REG_THREADS) wsb_regs_dense_kernel(
    const RegCosts<LT, G> costs, const Args a) {
  wsb_regs_body<LT, G, LOC, P, false, float, false, true>(costs, a, TagArgs{});
}

template <int LT, int G, int LOC, bool ROWS, typename E, bool DENSE>
int launch_regs(const HostCosts& h, int blocks, cudaStream_t stream,
                const Args& a, const TagArgs* t) {
  // costs past T only reach columns past the needle, or a lane's own C
  // (c - 0 = c): zero
  RegCosts<LT, G> c;
  for (int i = 0; i <= LT; ++i) c.w_s[i] = (i < h.n_ws) ? h.w_s[i] : 0.0f;
  for (int g = 0; g <= G; ++g) {
    c.w_t[g] = (g <= a.T) ? h.w_t[g] : 0.0f;
    c.w_ts[g] = (g <= a.T) ? h.w_ts[g] : 0.0f;
  }
  // gather: two problems a group where Q is even; the grid must cover
  // every group
  const int P = (!ROWS && a.Q % 2 == 0) ? 2 : 1;
  if ((int64_t)blocks * (REG_THREADS / G) * P < a.problems) return -1;
  if constexpr (DENSE) {
    if (P == 2)
      wsb_regs_dense_kernel<LT, G, LOC, 2><<<blocks, REG_THREADS, 0, stream>>>(c, a);
    else
      wsb_regs_dense_kernel<LT, G, LOC, 1><<<blocks, REG_THREADS, 0, stream>>>(c, a);
    return (int)cudaGetLastError();
  }
  if constexpr (std::is_same<E, float>::value) {
    if (t != nullptr) {
      if constexpr (ROWS)
        wsb_regs_tagged_kernel<LT, G, LOC, 1, true><<<blocks, REG_THREADS, 0, stream>>>(c, a, *t);
      else if (P == 2)
        wsb_regs_tagged_kernel<LT, G, LOC, 2, false><<<blocks, REG_THREADS, 0, stream>>>(c, a, *t);
      else
        wsb_regs_tagged_kernel<LT, G, LOC, 1, false><<<blocks, REG_THREADS, 0, stream>>>(c, a, *t);
      return (int)cudaGetLastError();
    }
  }
  if constexpr (ROWS) {
    wsb_regs_kernel<LT, G, LOC, 1, true, E><<<blocks, REG_THREADS, 0, stream>>>(c, a);
  } else if constexpr (!std::is_same<E, float>::value) {
    // a quantized table at an even Q is paired: one load a row for both
    if (P == 2)
      wsb_regs_paired_kernel<LT, G, LOC, E><<<blocks, REG_THREADS, 0, stream>>>(c, a);
    else
      wsb_regs_kernel<LT, G, LOC, 1, false, E><<<blocks, REG_THREADS, 0, stream>>>(c, a);
  } else if (P == 2) {
    wsb_regs_kernel<LT, G, LOC, 2, false, E><<<blocks, REG_THREADS, 0, stream>>>(c, a);
  } else {
    wsb_regs_kernel<LT, G, LOC, 1, false, E><<<blocks, REG_THREADS, 0, stream>>>(c, a);
  }
  return (int)cudaGetLastError();
}

template <int LT, int G, bool ROWS, typename E, bool DENSE>
int regs_locality(int locality, const HostCosts& h, int blocks,
                  cudaStream_t stream, const Args& a, const TagArgs* t) {
  switch (locality) {
    case LOCAL: return launch_regs<LT, G, LOCAL, ROWS, E, DENSE>(h, blocks, stream, a, t);
    case GLOBAL: return launch_regs<LT, G, GLOBAL, ROWS, E, DENSE>(h, blocks, stream, a, t);
    default: return launch_regs<LT, G, SEMIGLOBAL, ROWS, E, DENSE>(h, blocks, stream, a, t);
  }
}

template <int LT, bool ROWS, typename E, bool DENSE>
int regs_width(int locality, const HostCosts& h, int blocks,
               cudaStream_t stream, const Args& a, const TagArgs* t) {
  if (a.T <= 8) return regs_locality<LT, 8, ROWS, E, DENSE>(locality, h, blocks, stream, a, t);
  if (a.T <= 16) return regs_locality<LT, 16, ROWS, E, DENSE>(locality, h, blocks, stream, a, t);
  return regs_locality<LT, 32, ROWS, E, DENSE>(locality, h, blocks, stream, a, t);
}

template <bool ROWS, typename E, bool DENSE = false>
int regs_dispatch(Args a, const HostCosts& h, int n_wt, int locality,
                  int blocks, const TagArgs* t, void* stream) {
  if (a.problems <= 0 || a.Q <= 0 || a.L <= 0 || a.L > 32 || a.T <= 0 ||
      a.T > 32 || locality < 0 || locality > 2 || h.n_ws < a.L + 1 ||
      n_wt < a.T + 1 || blocks <= 0)
    return -1;
  a.small = a.problems <= 0xffffffffLL;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.L <= 8) return regs_width<8, ROWS, E, DENSE>(locality, h, blocks, st, a, t);
  if (a.L <= 16) return regs_width<16, ROWS, E, DENSE>(locality, h, blocks, st, a, t);
  return regs_width<32, ROWS, E, DENSE>(locality, h, blocks, st, a, t);
}

// ---------------------------------------------------------------------------
// long route
// ---------------------------------------------------------------------------

using KernelFn = void (*)(const Args);

constexpr int LONG_R = 8;         // DP rows a row block
constexpr int LONG_MAX_L = 256;   // the largest bucket capacity it takes

// Lane groups as on the register route (P = 1), the column history in
// shared memory.  Rows go in blocks of LONG_R.  Before a block, each lane
// streams its column's stored rows once and folds every one of them into
// the block's LONG_R vertical-gap accumulators (row b + u takes H[r] -
// w_s[b + u - r]): one 16-byte load serves 4 rows x LONG_R candidates, in
// LONG_R independent max chains, the costs of a stored block (2 LONG_R - 1
// of them, the same for the whole warp) read as broadcasts.  Inside the
// block the rows run as on the register route: the candidates of the
// block's own earlier rows from registers (costs w_s[1 .. LONG_R - 1]),
// the diagonal one shuffle, the horizontal gaps G - 1 shuffles against
// w_t*.  The block's rows are stored after it, 16 bytes a lane and 4
// rows: lane t's rows 4m .. 4m + 3 at hist4[m * blockDim.x + t], so a
// warp's loads and stores are contiguous.  Shared memory holds w_s[1 ..]
// (ncw floats, zero past L) and then the history, L rounded up to
// LONG_R rows a thread.
// The locality ``loc`` is a kernel argument (uniform branches), not a
// template one: a third of the templates to build.
template <int G, bool ROWS, typename E, bool DENSE>
__device__ __forceinline__ void wsb_long_body(const Args a, const int loc) {
  static_assert(!ROWS || std::is_same<E, float>::value, "rows read f32 tables");
  static_assert(!(ROWS && DENSE), "a dense block has no row gather");
  extern __shared__ float4 smem4[];
  const int Lr = (a.L + LONG_R - 1) / LONG_R * LONG_R;
  const int ncw = Lr + LONG_R;
  float* const wsh = reinterpret_cast<float*>(smem4);  // wsh[x] = w_s[x + 1]
  for (int x = threadIdx.x; x < ncw; x += blockDim.x)
    wsh[x] = (x < a.L) ? __ldg(a.w_s + x + 1) : 0.0f;
  float4* const hist4 = smem4 + ncw / 4 + threadIdx.x;
  const int hstride = blockDim.x;
  __syncthreads();

  const int64_t gthread = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int k = threadIdx.x & (G - 1);  // this lane's column is j = k + 1
  const int j = k + 1;
  const int64_t p_raw = gthread / G;
  const bool valid = p_raw < a.problems;
  const int64_t p = valid ? p_raw : 0;  // a tail group computes, stores nothing
  int64_t s;
  int q, ln, lt;
  if (ROWS) {
    s = (a.prow != nullptr) ? (int64_t)a.prow[p] : p;
    q = (a.pslot != nullptr) ? a.pslot[p] : 0;
    ln = a.len_s[p];
    lt = a.len_t[p];
  } else {
    split_problem(p, a.Q, a.small, s, q);
    ln = DENSE ? max(a.len_s[s], 1) : a.len_s[s];  // the dense block's len_s is raw
    lt = a.len_t[q];
  }
  const int rows = valid ? min(ln, a.L) : 0;
  // uniform bound of the warp: its longest slice
  const int rows_warp = __reduce_max_sync(FULL, rows);

  // costs past the needle are zero, as on the register route
  const bool col_in = k < a.T;
  const float wt_lane = col_in ? __ldg(a.w_t + j) : 0.0f;
  const float wts_lane = col_in ? __ldg(a.w_ts + j) : 0.0f;
  float wts[G];
#pragma unroll
  for (int g = 1; g < G; ++g) wts[g] = (g <= a.T) ? __ldg(a.w_ts + g) : 0.0f;
  float wsin[LONG_R];  // w_s[1 .. LONG_R - 1]: gaps inside a block
#pragma unroll
  for (int d = 1; d < LONG_R; ++d) wsin[d] = wsh[d - 1];
  const bool global = loc == GLOBAL, local = loc == LOCAL;
  const float e0 = 0.0f - wts_lane;
  const float h0 = global ? -wt_lane : 0.0f;  // H[0][j]

  const uint32_t T = (uint32_t)a.T;
  const int32_t* trow = (a.tokens != nullptr) ? a.tokens + s * (int64_t)a.L : nullptr;
  auto tok_at = [&](int i) -> uint32_t {
    return (DENSE || (ROWS && trow == nullptr)) ? (uint32_t)i
                                                : (uint32_t)__ldg(trow + i);
  };
  uint32_t vstride, off;
  if constexpr (DENSE) {
    vstride = (uint32_t)a.Q * T;
    off = (uint32_t)(s * a.L) * vstride + (uint32_t)q + (uint32_t)k * (uint32_t)a.Q;
  } else if (ROWS) {
    vstride = T;
    off = ((uint32_t)q * (uint32_t)a.V +
           (trow == nullptr ? (uint32_t)(s * a.L) : 0u)) * T + (uint32_t)k;
  } else {
    vstride = (uint32_t)a.Q * T;
    off = (uint32_t)q * T + (uint32_t)k;
  }
  const E* tcol = static_cast<const E*>(a.table) + off;

  float hprev = h0;  // H[i - 1][j]
  float acc = global ? NEG : 0.0f;
  const int last = (j <= lt) ? rows : 0;  // rows whose cell counts (local)

  for (int b = 1; b <= rows_warp; b += LONG_R) {
    // the block's similarities, in flight while the stored rows stream
    float sv[LONG_R];
#pragma unroll
    for (int u = 0; u < LONG_R; ++u) {
      const bool in = b + u <= rows;
      const uint32_t tok = in ? tok_at(b + u - 1) : 0u;
      sv[u] = (in && col_in) ? to_f32(__ldg(tcol + tok * vstride)) : 0.0f;
    }
    // vertical candidates from row 0 and from every stored block
    float vacc[LONG_R];
    {
      const float4* c4 = reinterpret_cast<const float4*>(wsh + b - 1);
#pragma unroll
      for (int u4 = 0; u4 < LONG_R / 4; ++u4) {
        const float4 c = c4[u4];
        vacc[4 * u4] = h0 - c.x;
        vacc[4 * u4 + 1] = h0 - c.y;
        vacc[4 * u4 + 2] = h0 - c.z;
        vacc[4 * u4 + 3] = h0 - c.w;
      }
    }
    for (int rb = 1; rb < b; rb += LONG_R) {
      float hr[LONG_R];  // rows rb .. rb + LONG_R - 1
#pragma unroll
      for (int m4 = 0; m4 < LONG_R / 4; ++m4) {
        const float4 h = hist4[((rb - 1) / 4 + m4) * hstride];
        hr[4 * m4] = h.x;
        hr[4 * m4 + 1] = h.y;
        hr[4 * m4 + 2] = h.z;
        hr[4 * m4 + 3] = h.w;
      }
      // row rb + m feeds row b + u at gap d0 + u - m: cw[u - m + LONG_R - 1]
      const int d0 = b - rb;
      float cw[2 * LONG_R];
      const float4* c4 = reinterpret_cast<const float4*>(wsh + d0 - LONG_R);
#pragma unroll
      for (int y4 = 0; y4 < LONG_R / 2; ++y4) {
        const float4 c = c4[y4];
        cw[4 * y4] = c.x;
        cw[4 * y4 + 1] = c.y;
        cw[4 * y4 + 2] = c.z;
        cw[4 * y4 + 3] = c.w;
      }
#pragma unroll
      for (int m = 0; m < LONG_R; ++m) {
#pragma unroll
        for (int u = 0; u < LONG_R; ++u)
          vacc[u] = fmaxf(vacc[u], hr[m] - cw[u - m + LONG_R - 1]);
      }
    }
    float hb[LONG_R];
#pragma unroll
    for (int u = 0; u < LONG_R; ++u) hb[u] = 0.0f;
#pragma unroll
    for (int u = 0; u < LONG_R; ++u) {
      const int i = b + u;
      if (i > rows_warp) break;
      float v = vacc[u];
#pragma unroll
      for (int m = 0; m < u; ++m) v = fmaxf(v, hb[m] - wsin[u - m]);
      // diagonal: H[i - 1][j - 1] + S[i - 1][j - 1]
      const float up = __shfl_up_sync(FULL, hprev, 1, G);
      const float h_prev0 = (global && i > 1) ? -wsh[i - 2] : 0.0f;
      const float dg = ((k == 0) ? h_prev0 : up) + sv[u];
      float c = fmaxf(dg, v);
      if (local) c = fmaxf(c, 0.0f);
      // horizontal gaps, as on the register route (w_t* >= 0)
      float e = global ? -wsh[i - 1] - wts_lane : e0;
#pragma unroll
      for (int g = 1; g < G; ++g)
        e = fmaxf(e, __shfl_up_sync(FULL, c, g, G) - wts[g]);
      const float h = fmaxf(c, e);
      hb[u] = h;
      hprev = h;
      if (local) {
        if (i <= last) acc = fmaxf(acc, h);
      } else if (global) {
        if (i == ln && j == lt) acc = h;
      } else {
        if (i <= rows && j == lt) acc = fmaxf(acc, h);
        if (i == ln && j <= lt) acc = fmaxf(acc, h);
      }
    }
    if (b + LONG_R <= rows_warp) {  // a later block reads these rows
#pragma unroll
      for (int m4 = 0; m4 < LONG_R / 4; ++m4)
        hist4[((b - 1) / 4 + m4) * hstride] =
            make_float4(hb[4 * m4], hb[4 * m4 + 1], hb[4 * m4 + 2], hb[4 * m4 + 3]);
    }
  }
#pragma unroll
  for (int off2 = G / 2; off2 > 0; off2 >>= 1)
    acc = fmaxf(acc, __shfl_xor_sync(FULL, acc, off2, G));
  if (valid && k == 0)
    a.out[p] = (ROWS && a.mask_empty && ln <= 0) ? NEG : acc;
}

template <int G, bool ROWS, typename E>
__global__ void __launch_bounds__(128) wsb_long_kernel(const Args a, const int loc) {
  wsb_long_body<G, ROWS, E, false>(a, loc);
}

template <int G>
__global__ void __launch_bounds__(128) wsb_long_dense_kernel(const Args a, const int loc) {
  wsb_long_body<G, false, float, true>(a, loc);
}

// The shared bytes a block of ``threads`` threads needs at capacity L.
int64_t long_smem_bytes(int L, int threads) {
  const int64_t Lr = (L + LONG_R - 1) / LONG_R * LONG_R;
  return (Lr + LONG_R + Lr * threads) * 4;
}

using LongFn = void (*)(const Args, const int);

template <int G, bool ROWS, typename E, bool DENSE>
LongFn pick_long() {
  if constexpr (DENSE)
    return wsb_long_dense_kernel<G>;
  else
    return wsb_long_kernel<G, ROWS, E>;
}

// blocks of ``threads`` (32, 64 or 128) threads, G lanes a problem,
// ``smem_bytes`` at least long_smem_bytes(L, threads); the table holds fewer
// than 2^32 elements
template <bool ROWS, typename E, bool DENSE = false>
int long_dispatch(Args a, int locality, int blocks, int threads, int smem_bytes,
                  void* stream) {
  if (a.problems <= 0 || a.Q <= 0 || a.L <= 0 || a.L > LONG_MAX_L || a.T <= 0 ||
      a.T > 32 || locality < 0 || locality > 2 || blocks <= 0 ||
      (threads != 32 && threads != 64 && threads != 128) ||
      (int64_t)smem_bytes < long_smem_bytes(a.L, threads))
    return -1;
  const int G = a.T <= 8 ? 8 : a.T <= 16 ? 16 : 32;
  if ((int64_t)blocks * (threads / G) < a.problems) return -1;
  a.small = a.problems <= 0xffffffffLL;
  const LongFn kernel = G == 8 ? pick_long<8, ROWS, E, DENSE>()
                        : G == 16 ? pick_long<16, ROWS, E, DENSE>()
                                  : pick_long<32, ROWS, E, DENSE>();
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(a, locality);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wide route
// ---------------------------------------------------------------------------

constexpr int WIDE_MAX_T = 512;  // the widest padded needle it takes (16 slots)
constexpr int WIDE_XP = 36;      // +inf costs left of gap 1 in the cost copy

// Floats of shared memory a block of ``warps`` warps takes at (L, T)
// (ops/dp_kernels.wsb_wide_smem mirrors it): the closure's copy (WIDE_XP
// +inf, w_t*[1 .. Tc], 4 more; Tc = T rounded up to 32), w_s[0 .. L] (to
// a multiple of 4), then per warp its C row (Tc + 4) and its column
// history (L rows of T floats, to a multiple of 4).  Every region starts on
// 16 bytes.
int64_t wide_smem_floats(int L, int T, int warps) {
  const int64_t tc = (int64_t)(T + 31) / 32 * 32;
  const int64_t per_warp = tc + 4 + ((int64_t)L * T + 3) / 4 * 4;
  return (WIDE_XP + tc + 4) + ((int64_t)L + 4) / 4 * 4 + warps * per_warp;
}

// One warp a problem; DP column j = 32c + lane + 1 at register slot c of
// lane ``lane`` (CPL slots; the problem's ncs = ceil(len_t / 32) run, a
// uniform bound of the warp).  Rows run one at a time: the vertical gaps
// against the warp's shared history (own columns only: no lane reads
// another's), the diagonal one shuffle a slot, C into the warp's shared
// row, then the horizontal gaps in one walk over k (see the header).  A
// column at or past len_t computes from zeros and reaches no cell that
// counts.  The locality ``loc`` is a kernel argument, as on the long route.
template <int CPL, bool ROWS, typename E, bool DENSE>
__device__ __forceinline__ void wsb_wide_body(const Args a, const int loc) {
  static_assert(!ROWS || std::is_same<E, float>::value, "rows read f32 tables");
  static_assert(!(ROWS && DENSE), "a dense block has no row gather");
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const float inf = __int_as_float(0x7f800000);
  const int L = a.L, T = a.T;
  const int tc = (T + 31) / 32 * 32;
  const int nwx = WIDE_XP + tc + 4, nws = (L + 4) / 4 * 4;
  float* const wx = sm;         // wx[WIDE_XP + g] = w_t*[g] for 1 <= g <= T, +inf elsewhere
  float* const wsh = sm + nwx;  // wsh[d] = w_s[d], d <= L
  for (int x = threadIdx.x; x < nwx; x += blockDim.x) {
    const int g = x - WIDE_XP;
    wx[x] = (g >= 1 && g <= T) ? __ldg(a.w_ts + g) : inf;
  }
  for (int x = threadIdx.x; x < nws; x += blockDim.x)
    wsh[x] = (x <= L) ? __ldg(a.w_s + x) : 0.0f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const crow = sm + nwx + nws + warp * (tc + 4 + (L * T + 3) / 4 * 4);
  float* const hist = crow + tc + 4;  // row r (1 ..) of column x at hist[(r - 1) * T + x]
  __syncthreads();

  const int64_t p = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= a.problems) return;  // a whole warp; no block barrier follows
  int64_t s;
  int q, ln, lt;
  if (ROWS) {
    s = (a.prow != nullptr) ? (int64_t)a.prow[p] : p;
    q = (a.pslot != nullptr) ? a.pslot[p] : 0;
    ln = a.len_s[p];
    lt = a.len_t[p];
  } else {
    split_problem(p, a.Q, a.small, s, q);
    ln = DENSE ? max(a.len_s[s], 1) : a.len_s[s];  // the dense block's len_s is raw
    lt = a.len_t[q];
  }
  const int rows = min(ln, L);
  const int ncs = min((lt + 31) >> 5, CPL);
  const bool global = loc == GLOBAL, local = loc == LOCAL;

  // row i (0-based) of the problem's similarities at row_at(i), column x
  // at x * xs
  const E* const tab = static_cast<const E*>(a.table);
  const int32_t* const trow = (a.tokens != nullptr) ? a.tokens + s * (int64_t)L : nullptr;
  int64_t rstride, base, xs = 1;
  if constexpr (DENSE) {
    // row i of slice s at (s * L + i) * T * Q, column x of query q at x * Q + q
    rstride = (int64_t)T * a.Q;
    base = s * L * rstride + q;
    xs = a.Q;
  } else if (ROWS) {
    rstride = T;
    base = ((int64_t)q * a.V + (trow == nullptr ? s * L : 0)) * T;
  } else {
    rstride = (int64_t)a.Q * T;  // the query-major [V, Q, T] copy
    base = (int64_t)q * T;
  }
  auto row_at = [&](int i) -> const E* {
    const int64_t r = (DENSE || trow == nullptr) ? (int64_t)i : (int64_t)__ldg(trow + i);
    return tab + base + r * rstride;
  };
  auto load_row = [&](float (&v)[CPL], int i) {
    const E* const r = row_at(i);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int x = 32 * c + lane;
      v[c] = (c < ncs && x < lt) ? to_f32(__ldg(r + x * xs)) : 0.0f;
    }
  };

  float h0[CPL], hp[CPL], sv[CPL];  // H[0][j], H[i - 1][j], row i's similarities
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int j = 32 * c + lane + 1;
    h0[c] = (global && j <= T) ? -__ldg(a.w_t + j) : 0.0f;
    hp[c] = h0[c];
    sv[c] = 0.0f;
  }
  if (rows >= 1) load_row(sv, 0);
  float acc = global ? NEG : 0.0f;

  for (int i = 1; i <= rows; ++i) {
    float cur[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) cur[c] = sv[c];
    if (i < rows) load_row(sv, i);  // the next row's, in flight through this one

    // vertical gaps: H[r][j] - w_s[i - r] over r < i (row 0 in registers)
    float cc[CPL];
    {
      const float w = wsh[i];
#pragma unroll
      for (int c = 0; c < CPL; ++c) cc[c] = h0[c] - w;
    }
    for (int r = 1; r < i; ++r) {
      const float w = wsh[i - r];
      const float* const hr = hist + (r - 1) * T + lane;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (c < ncs && 32 * c + lane < lt) cc[c] = fmaxf(cc[c], hr[32 * c] - w);
    }
    // diagonal H[i - 1][j - 1] + S[i - 1][j - 1]: lane 0 of slot c reads
    // column 32c, lane 31's of slot c - 1 (its own rotated value there)
    float below = (global && i > 1) ? -wsh[i - 1] : 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (c < ncs) {
        const float rot = __shfl_sync(FULL, hp[c], (lane + 31) & 31);
        float v = fmaxf(((lane == 0) ? below : rot) + cur[c], cc[c]);
        if (local) v = fmaxf(v, 0.0f);
        cc[c] = v;
        crow[32 * c + lane + 1] = v;
        below = rot;
      }
    }
    if (lane == 0) crow[0] = global ? -wsh[i] : 0.0f;
    __syncwarp();

    // horizontal gaps: E[j] = max_k C[k] - w_t*[j - k], a slot at a time,
    // its walk ending at its last column, four k a step (one walk over k
    // for all slots, each slot's step predicated, issued every slot's
    // instructions at every step: 50.1 ms against this form's 29.8 at phase
    // 4's 160-token find, PERF.md)
    float e[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      e[c] = NEG;
      if (c < ncs) {
        const int kend = min(lt, 32 * c + 32);
        const float* const wc = wx + WIDE_XP + 1 + lane + 32 * c;  // gap j - k at k = 0
        float ec = NEG;
#pragma unroll 2
        for (int k0 = 0; k0 < kend; k0 += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(crow + k0);
          const float* const w = wc - k0;
          ec = fmaxf(ec, fmaxf(fmaxf(c4.x - w[0], c4.y - w[-1]),
                               fmaxf(c4.z - w[-2], c4.w - w[-3])));
        }
        e[c] = ec;
      }
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (c < ncs) {
        const int x = 32 * c + lane, j = x + 1;
        const float h = fmaxf(cc[c], e[c]);
        hp[c] = h;
        if (i < rows && x < lt) hist[(i - 1) * T + x] = h;
        if (local) {
          if (j <= lt) acc = fmaxf(acc, h);
        } else if (global) {
          if (i == ln && j == lt) acc = h;
        } else {
          if (j == lt) acc = fmaxf(acc, h);
          if (i == ln && j <= lt) acc = fmaxf(acc, h);
        }
      }
    }
    __syncwarp();  // the next row rewrites the C row
  }
#pragma unroll
  for (int off2 = 16; off2 > 0; off2 >>= 1)
    acc = fmaxf(acc, __shfl_xor_sync(FULL, acc, off2));
  if (lane == 0) a.out[p] = (ROWS && a.mask_empty && ln <= 0) ? NEG : acc;
}

template <int CPL, bool ROWS, typename E>
__global__ void __launch_bounds__(128) wsb_wide_kernel(const Args a, const int loc) {
  wsb_wide_body<CPL, ROWS, E, false>(a, loc);
}

template <int CPL>
__global__ void __launch_bounds__(128) wsb_wide_dense_kernel(const Args a, const int loc) {
  wsb_wide_body<CPL, false, float, true>(a, loc);
}

template <int CPL, bool ROWS, typename E, bool DENSE>
LongFn pick_wide() {
  if constexpr (DENSE)
    return wsb_wide_dense_kernel<CPL>;
  else
    return wsb_wide_kernel<CPL, ROWS, E>;
}

// blocks of ``threads`` (32, 64 or 128) threads, one warp a problem,
// ``smem_bytes`` at least 4 * wide_smem_floats(L, T, threads / 32); the
// slots a lane holds: the least of 2, 4, 8, 16 that covers T
template <bool ROWS, typename E, bool DENSE = false>
int wide_dispatch(Args a, int locality, int blocks, int threads, int smem_bytes,
                  void* stream) {
  if (a.problems <= 0 || a.Q <= 0 || a.L <= 0 || a.T <= 32 || a.T > WIDE_MAX_T ||
      locality < 0 || locality > 2 || blocks <= 0 ||
      (threads != 32 && threads != 64 && threads != 128) ||
      (int64_t)smem_bytes < 4 * wide_smem_floats(a.L, a.T, threads / 32))
    return -1;
  if ((int64_t)blocks * (threads / 32) < a.problems) return -1;
  a.small = a.problems <= 0xffffffffLL;
  const LongFn kernel = a.T <= 64    ? pick_wide<2, ROWS, E, DENSE>()
                        : a.T <= 128 ? pick_wide<4, ROWS, E, DENSE>()
                        : a.T <= 256 ? pick_wide<8, ROWS, E, DENSE>()
                                     : pick_wide<16, ROWS, E, DENSE>();
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(a, locality);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// shared / scratch route
// ---------------------------------------------------------------------------
using TaggedFn = void (*)(const Args, const TagArgs);

template <int THREADS>
KernelFn pick_dense(int locality) {
  switch (locality) {
    case LOCAL: return wsb_dp_dense_kernel<LOCAL, THREADS>;
    case GLOBAL: return wsb_dp_dense_kernel<GLOBAL, THREADS>;
    default: return wsb_dp_dense_kernel<SEMIGLOBAL, THREADS>;
  }
}

template <bool GATHER, int THREADS, typename E>
KernelFn pick(int locality) {
  switch (locality) {
    case LOCAL: return wsb_dp_kernel<LOCAL, GATHER, THREADS, E>;
    case GLOBAL: return wsb_dp_kernel<GLOBAL, GATHER, THREADS, E>;
    default: return wsb_dp_kernel<SEMIGLOBAL, GATHER, THREADS, E>;
  }
}

template <bool GATHER, int THREADS>
TaggedFn pick_tagged(int locality) {
  switch (locality) {
    case LOCAL: return wsb_dp_tagged_kernel<LOCAL, GATHER, THREADS>;
    case GLOBAL: return wsb_dp_tagged_kernel<GLOBAL, GATHER, THREADS>;
    default: return wsb_dp_tagged_kernel<SEMIGLOBAL, GATHER, THREADS>;
  }
}

// The kernel of a launch, tagged or not (``Fn``: KernelFn or TaggedFn);
// DENSE: the dense entry's family.
template <typename Fn, bool GATHER, typename E, bool DENSE>
Fn pick_kernel(const Args& a, int locality, int threads) {
  if constexpr (DENSE) {
    if (a.scratch != nullptr) return pick_dense<0>(locality);
    if (threads == 32) return pick_dense<32>(locality);
    if (threads == 64) return pick_dense<64>(locality);
    if (threads == 128) return pick_dense<128>(locality);
  } else if constexpr (std::is_same<Fn, TaggedFn>::value) {
    if (a.scratch != nullptr) return pick_tagged<GATHER, 0>(locality);
    if (threads == 32) return pick_tagged<GATHER, 32>(locality);
    if (threads == 64) return pick_tagged<GATHER, 64>(locality);
    if (threads == 128) return pick_tagged<GATHER, 128>(locality);
  } else {
    if (a.scratch != nullptr) return pick<GATHER, 0, E>(locality);
    if (threads == 32) return pick<GATHER, 32, E>(locality);
    if (threads == 64) return pick<GATHER, 64, E>(locality);
    if (threads == 128) return pick<GATHER, 128, E>(locality);
  }
  return nullptr;
}

// ``scratch`` is null for rows in shared memory (smem_bytes per block of
// 32, 64 or 128 threads), else a buffer of blocks * threads * (L + 1) *
// (T + 1) floats.
template <bool GATHER, typename E, bool DENSE = false>
int launch(const Args& a, int locality, int blocks, int threads,
           int smem_bytes, const TagArgs* t, void* stream) {
  if (a.problems <= 0 || a.L <= 0 || a.T <= 0 || a.Q <= 0 || locality < 0 ||
      locality > 2)
    return -1;
  if (blocks <= 0 || threads <= 0 || threads > 128 || smem_bytes < 0)
    return -1;
  // shared rows need every thread's (L + 1) x (T + 1) floats
  if (a.scratch == nullptr &&
      (int64_t)smem_bytes < (int64_t)(a.L + 1) * (a.T + 1) * threads * 4)
    return -1;
  if constexpr (std::is_same<E, float>::value && !DENSE) {
    if (t != nullptr) {
      const TaggedFn kernel = pick_kernel<TaggedFn, GATHER, E, false>(a, locality, threads);
      if (kernel == nullptr) return -1;
      if (smem_bytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
        if (err != cudaSuccess) return (int)err;
      }
      kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(a, *t);
      return (int)cudaGetLastError();
    }
  }
  const KernelFn kernel = pick_kernel<KernelFn, GATHER, E, DENSE>(a, locality, threads);
  if (kernel == nullptr) return -1;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry returns the cudaError_t of the launch (0 on success), or -1
// when the arguments are outside what the kernel takes.  ``tag``: a host
// pointer to the tag-weighted block's inputs (copied into the launch), or
// null; only an f32 table with token ids takes it (a row-gather entry's tag
// rows index like ``tokens``, its slots like ``qslot``).

namespace {
// Whether a launch can take ``tag``: every array given, the weight table's
// rows 16-byte aligned.
bool tag_ok(const TagArgs* tag, int table_dtype, const int32_t* tokens) {
  return tag == nullptr ||
         (table_dtype == F32 && tokens != nullptr && tag->pos != nullptr &&
          tag->w != nullptr && tag->p != nullptr && tag->pen != nullptr &&
          tag->thr != nullptr && tag->wt != nullptr && tag->rmap != nullptr &&
          reinterpret_cast<uintptr_t>(tag->wt) % 16 == 0 && tag->wr % 4 == 0 &&
          tag->wq % 4 == 0);
}
}  // namespace

// Gather entries: ``table`` of ``table_dtype`` (TableDtype: f32, bf16 bits
// or int8).

// Gather entry, shared / scratch route (``scratch`` as in ``launch``).
extern "C" int vt_wsb_dp_scores(
    const void* table, int table_dtype, const int32_t* tokens,
    const int32_t* len_s, const int32_t* len_t, const float* w_s,
    const float* w_t, const float* w_ts, float* out, float* scratch, int64_t n,
    int L, int T, int Q, int locality, int blocks, int threads, int smem_bytes,
    const TagArgs* tag, void* stream) {
  if (Q <= 0 || tokens == nullptr || !tag_ok(tag, table_dtype, tokens)) return -1;
  const Args a{table, tokens, nullptr, nullptr, len_s, len_t, w_s, w_t, w_ts,
               out, scratch, n * (int64_t)Q, L, T, Q, 0, false, false};
  switch (table_dtype) {
    case F32: return launch<true, float>(a, locality, blocks, threads, smem_bytes, tag, stream);
    case BF16: return launch<true, uint16_t>(a, locality, blocks, threads, smem_bytes, nullptr, stream);
    case INT8: return launch<true, int8_t>(a, locality, blocks, threads, smem_bytes, nullptr, stream);
    default: return -1;
  }
}

// Gather entry, register route (``blocks`` of REG_THREADS threads, G lanes
// a group, two problems a group where Q is even): ``table`` is [V, Q, T];
// w_s (n_ws >= L + 1 floats), w_t and w_ts (n_wt >= T + 1 floats each) are
// HOST pointers, copied into the launch's parameters (the buffers may be
// freed once this returns).  L <= 32, T <= 32, w_ts[1..T - 1] >= 0, and the
// table holds fewer than 2^32 elements.  A bf16 or int8 table at an even Q
// is paired instead: [V, Q / 2, T, 2], element (v, q, j) at ((v * Q / 2 + q
// / 2) * T + j) * 2 + q % 2.
extern "C" int vt_wsb_dp_scores_regs(
    const void* table, int table_dtype, const int32_t* tokens,
    const int32_t* len_s, const int32_t* len_t, const float* w_s, int n_ws,
    const float* w_t, const float* w_ts, int n_wt, float* out, int64_t n,
    int L, int T, int Q, int locality, int blocks, const TagArgs* tag,
    void* stream) {
  if (n <= 0 || Q <= 0 || tokens == nullptr || !tag_ok(tag, table_dtype, tokens))
    return -1;
  const Args a{table, tokens, nullptr, nullptr, len_s, len_t, nullptr,
               nullptr, nullptr, out, nullptr, n * (int64_t)Q, L, T, Q, 0,
               false, false};
  const HostCosts h{w_s, n_ws, w_t, w_ts};
  switch (table_dtype) {
    case F32: return regs_dispatch<false, float>(a, h, n_wt, locality, blocks, tag, stream);
    case BF16: return regs_dispatch<false, uint16_t>(a, h, n_wt, locality, blocks, nullptr, stream);
    case INT8: return regs_dispatch<false, int8_t>(a, h, n_wt, locality, blocks, nullptr, stream);
    default: return -1;
  }
}

// Row-gather entry, shared / scratch route: ``table`` [slots * V, T];
// ``tokens`` [n, L] or null (the table is S, [B * L, T]); ``rows`` /
// ``qslot`` [B] or null (b / 0); ``mask_empty`` nonzero: a problem with
// len_s <= 0 scores -1e30.
extern "C" int vt_wsb_dp_scores_rows(
    const float* table, const int32_t* tokens, const int32_t* rows,
    const int32_t* qslot, const int32_t* len_s, const int32_t* len_t,
    const float* w_s, const float* w_t, const float* w_ts, float* out,
    float* scratch, int64_t B, int L, int T, int64_t V, int locality,
    int mask_empty, int blocks, int threads, int smem_bytes,
    const TagArgs* tag, void* stream) {
  if (!tag_ok(tag, F32, tokens)) return -1;
  const Args a{table, tokens, rows, qslot, len_s, len_t, w_s, w_t, w_ts, out,
               scratch, B, L, T, 1, V, false, mask_empty != 0};
  return launch<false, float>(a, locality, blocks, threads, smem_bytes, tag, stream);
}

// Row-gather entry, register route (one problem a group; costs on the host
// as in vt_wsb_dp_scores_regs; the table holds fewer than 2^32 floats).
extern "C" int vt_wsb_dp_scores_rows_regs(
    const float* table, const int32_t* tokens, const int32_t* rows,
    const int32_t* qslot, const int32_t* len_s, const int32_t* len_t,
    const float* w_s, int n_ws, const float* w_t, const float* w_ts, int n_wt,
    float* out, int64_t B, int L, int T, int64_t V, int locality,
    int mask_empty, int blocks, const TagArgs* tag, void* stream) {
  if (!tag_ok(tag, F32, tokens)) return -1;
  const Args a{table, tokens, rows, qslot, len_s, len_t, nullptr, nullptr,
               nullptr, out, nullptr, B, L, T, 1, V, false, mask_empty != 0};
  return regs_dispatch<true, float>(a, HostCosts{w_s, n_ws, w_t, w_ts}, n_wt,
                                    locality, blocks, tag, stream);
}

// Dense entries: ``S`` the [c, L, T, Q] f32 block; ``len_s`` [c] (raw: every
// dense kernel clamps it to >= 1); ``len_t`` [Q].  Shared / scratch route (arguments as in vt_wsb_dp_scores).
extern "C" int vt_wsb_dp_scores_dense(
    const float* S, const int32_t* len_s, const int32_t* len_t,
    const float* w_s, const float* w_t, const float* w_ts, float* out,
    float* scratch, int64_t c, int L, int T, int Q, int locality, int blocks,
    int threads, int smem_bytes, void* stream) {
  if (S == nullptr || Q <= 0) return -1;
  const Args a{S, nullptr, nullptr, nullptr, len_s, len_t, w_s, w_t, w_ts,
               out, scratch, c * (int64_t)Q, L, T, Q, 0, false, false};
  return launch<true, float, true>(a, locality, blocks, threads, smem_bytes, nullptr, stream);
}

// Dense entry, register route (costs on the host as in
// vt_wsb_dp_scores_regs; the block holds fewer than 2^32 floats).
extern "C" int vt_wsb_dp_scores_dense_regs(
    const float* S, const int32_t* len_s, const int32_t* len_t,
    const float* w_s, int n_ws, const float* w_t, const float* w_ts, int n_wt,
    float* out, int64_t c, int L, int T, int Q, int locality, int blocks,
    void* stream) {
  if (S == nullptr || c <= 0 || Q <= 0) return -1;
  const Args a{S, nullptr, nullptr, nullptr, len_s, len_t, nullptr, nullptr,
               nullptr, out, nullptr, c * (int64_t)Q, L, T, Q, 0, false, false};
  return regs_dispatch<false, float, true>(a, HostCosts{w_s, n_ws, w_t, w_ts},
                                           n_wt, locality, blocks, nullptr, stream);
}

// Long route (bucket capacity L <= 256, T <= 32, w_ts[1..T - 1] >= 0;
// ``blocks`` of ``threads`` threads with ``smem_bytes`` of shared memory
// each, as ops/dp_kernels.wsb_launch_plan sizes them; the table or block
// holds fewer than 2^32 elements).  w_s (L + 1 floats), w_t and w_ts (T + 1
// each) are device pointers.  Gather: ``table`` [V, Q, T] of
// ``table_dtype`` (unpaired at any Q).
extern "C" int vt_wsb_dp_scores_long(
    const void* table, int table_dtype, const int32_t* tokens,
    const int32_t* len_s, const int32_t* len_t, const float* w_s,
    const float* w_t, const float* w_ts, float* out, int64_t n, int L, int T,
    int Q, int locality, int blocks, int threads, int smem_bytes, void* stream) {
  if (n <= 0 || Q <= 0 || tokens == nullptr) return -1;
  const Args a{table, tokens, nullptr, nullptr, len_s, len_t, w_s, w_t, w_ts,
               out, nullptr, n * (int64_t)Q, L, T, Q, 0, false, false};
  switch (table_dtype) {
    case F32: return long_dispatch<false, float>(a, locality, blocks, threads, smem_bytes, stream);
    case BF16: return long_dispatch<false, uint16_t>(a, locality, blocks, threads, smem_bytes, stream);
    case INT8: return long_dispatch<false, int8_t>(a, locality, blocks, threads, smem_bytes, stream);
    default: return -1;
  }
}

// Row-gather entry, long route (arguments as in vt_wsb_dp_scores_rows).
extern "C" int vt_wsb_dp_scores_rows_long(
    const float* table, const int32_t* tokens, const int32_t* rows,
    const int32_t* qslot, const int32_t* len_s, const int32_t* len_t,
    const float* w_s, const float* w_t, const float* w_ts, float* out,
    int64_t B, int L, int T, int64_t V, int locality, int mask_empty,
    int blocks, int threads, int smem_bytes, void* stream) {
  const Args a{table, tokens, rows, qslot, len_s, len_t, w_s, w_t, w_ts, out,
               nullptr, B, L, T, 1, V, false, mask_empty != 0};
  return long_dispatch<true, float>(a, locality, blocks, threads, smem_bytes, stream);
}

// Dense entry, long route (arguments as in vt_wsb_dp_scores_dense).
extern "C" int vt_wsb_dp_scores_dense_long(
    const float* S, const int32_t* len_s, const int32_t* len_t,
    const float* w_s, const float* w_t, const float* w_ts, float* out,
    int64_t c, int L, int T, int Q, int locality, int blocks, int threads,
    int smem_bytes, void* stream) {
  if (S == nullptr || c <= 0 || Q <= 0) return -1;
  const Args a{S, nullptr, nullptr, nullptr, len_s, len_t, w_s, w_t, w_ts,
               out, nullptr, c * (int64_t)Q, L, T, Q, 0, false, false};
  return long_dispatch<false, float, true>(a, locality, blocks, threads, smem_bytes, stream);
}

// Wide route (needles padded to 33-512 columns, any closure, no tags;
// ``blocks`` of ``threads`` threads, one warp a problem, ``smem_bytes`` of
// shared memory each, as ops/dp_kernels.wsb_launch_plan sizes them).  w_s
// (L + 1 floats), w_t and w_ts (T + 1 each) are device pointers.  Gather:
// ``table`` [V, Q, T] of ``table_dtype`` (query-major, as the long route
// reads it).
extern "C" int vt_wsb_dp_scores_wide(
    const void* table, int table_dtype, const int32_t* tokens,
    const int32_t* len_s, const int32_t* len_t, const float* w_s,
    const float* w_t, const float* w_ts, float* out, int64_t n, int L, int T,
    int Q, int locality, int blocks, int threads, int smem_bytes, void* stream) {
  if (n <= 0 || Q <= 0 || tokens == nullptr) return -1;
  const Args a{table, tokens, nullptr, nullptr, len_s, len_t, w_s, w_t, w_ts,
               out, nullptr, n * (int64_t)Q, L, T, Q, 0, false, false};
  switch (table_dtype) {
    case F32: return wide_dispatch<false, float>(a, locality, blocks, threads, smem_bytes, stream);
    case BF16: return wide_dispatch<false, uint16_t>(a, locality, blocks, threads, smem_bytes, stream);
    case INT8: return wide_dispatch<false, int8_t>(a, locality, blocks, threads, smem_bytes, stream);
    default: return -1;
  }
}

// Row-gather entry, wide route (arguments as in vt_wsb_dp_scores_rows).
extern "C" int vt_wsb_dp_scores_rows_wide(
    const float* table, const int32_t* tokens, const int32_t* rows,
    const int32_t* qslot, const int32_t* len_s, const int32_t* len_t,
    const float* w_s, const float* w_t, const float* w_ts, float* out,
    int64_t B, int L, int T, int64_t V, int locality, int mask_empty,
    int blocks, int threads, int smem_bytes, void* stream) {
  const Args a{table, tokens, rows, qslot, len_s, len_t, w_s, w_t, w_ts, out,
               nullptr, B, L, T, 1, V, false, mask_empty != 0};
  return wide_dispatch<true, float>(a, locality, blocks, threads, smem_bytes, stream);
}

// Dense entry, wide route (arguments as in vt_wsb_dp_scores_dense).
extern "C" int vt_wsb_dp_scores_dense_wide(
    const float* S, const int32_t* len_s, const int32_t* len_t,
    const float* w_s, const float* w_t, const float* w_ts, float* out,
    int64_t c, int L, int T, int Q, int locality, int blocks, int threads,
    int smem_bytes, void* stream) {
  if (S == nullptr || c <= 0 || Q <= 0) return -1;
  const Args a{S, nullptr, nullptr, nullptr, len_s, len_t, w_s, w_t, w_ts,
               out, nullptr, c * (int64_t)Q, L, T, Q, 0, false, false};
  return wide_dispatch<false, float, true>(a, locality, blocks, threads, smem_bytes, stream);
}
