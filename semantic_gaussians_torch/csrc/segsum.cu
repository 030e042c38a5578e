// Contiguous segment sum: out[g, :] = sum of rows i of cot with owners[i] == g.
//
// Replaces the TPU kernels semantic_gaussians_tpu/ops/segsum.py::_kernel_vmem
// and ::_kernel_panel (run by segsum_contiguous from ops/rasterize.py's
// pack_gather VJP). Those two compute one function and differ only in how
// a TPU's VMEM holds the accumulator (whole, or a rolling panel); a GPU
// needs neither, so this one kernel replaces both.
//
// Layout: cot is [P, D] row-major (a pair's gradient row is contiguous, as
// the composite backward writes it), out is [num_rows, D]. owners is
// non-decreasing (generation-order pair owners); the kernel relies only on
// that, not on the steps of at most 1 that the JAX kernels need. Rows at
// or past *limit (when given: the valid pair count) are treated as zero and
// never read.
//
// What bounds it on the H100: bytes. Each live row is read once (D floats)
// and each output row written once; one add per element read. So the work
// is handed out by INPUT rows, whatever the segments' lengths:
//
//   * A tile is `rows` consecutive input rows by a panel of `cw` columns
//     (all D columns when D <= 128, else D is cut into equal panels); the
//     tile is at most 48 KB of shared memory, so that several blocks share
//     an SM and one block's copies fly while another sums. Blocks take
//     tiles in a grid-stride loop and stop at the first tile at or past
//     *limit, so the grid follows the card (SMs x resident blocks), not P.
//   * The tile's owners are loaded once, coalesced, and its rows come in
//     by cp.async (16 bytes a thread where the alignment allows: always when
//     the panel is the whole row, since a tile then is one contiguous span).
//     Segment boundaries are where owners[i] != owners[i - 1]: no search.
//   * The tile is cut into `slices` of consecutive rows; a thread owns one
//     (slice, four neighbouring columns; one where the panel's width is no
//     multiple of 4), walks its rows in order and writes every run that
//     lies inside the slice straight to out. First and last runs are joined
//     across slices in slice order (segchain.cuh). Runs inside the tile are
//     written by that tile alone.
//   * The tile's first and last runs may continue in its neighbours: they go
//     to a carry buffer [tiles, 2, D] with their owners (-1: no last run,
//     the tile is one run). The carries are a stream of the same kind (rows
//     with non-decreasing owners, absent ones skipped), 2 / rows as long, so
//     the same kernel reduces them, level by level, until one tile is left,
//     whose carries are final. A segment of any length is summed by a tree
//     of fixed shape: rows in order within a slice, slices within a tile,
//     tiles within a tile of carries, and so on. No float atomics, no
//     dependence on block scheduling: two runs give the same bits.
//   * Most runs are short, and a carry level costs microseconds whatever it
//     holds. So at the first level a tile also publishes its carries behind
//     tags (its two owners, each under the call's epoch) and looks back: the tile that
//     sees a run end (it is cut inside that tile, or the next tile begins
//     with another owner, or the stream ends) reads the carries of the tiles
//     before it, back to where the run began, adds them in tile order and
//     writes the run. A run that reaches back over more than MAX_HOPS tiles
//     is left alone and marks the call as deferred; only then (or where the
//     stream is too long for looking back to pay) do the carry levels run,
//     over all carries as before (they rewrite the rows that the
//     look-back wrote, so the result of a call depends on its data alone).
//     Every block of the grid is resident, and a tile waits only for tiles
//     before it, so the waits end.
//   * A level is one launch while it has many tiles. Once the next level is
//     small (a few tiles or fewer, counted from P), the blocks of a
//     launch take an integer ticket as they finish, and the block that
//     draws the last one runs the remaining levels itself, tile after tile:
//     a training step's segment sum (P ~ 1.2M) is one launch. Which block
//     that is changes nothing in the sums.
//   * Rows of out that no pair owns are written as zeros exactly once: the
//     rows before the first and after the last owner are shared out over
//     the whole grid of the first level, and a gap inside the stream is
//     zeroed by the tile that sees owners step over it.
//   * The call's epoch lives on the device, in the first word of the tags'
//     buffer: a one-block kernel raises it by one before level 0, on the
//     same stream, and every level reads it when it starts. So every
//     launch, eager or replayed from a CUDA graph (which freezes launch
//     arguments), runs under an epoch that no earlier launch on that buffer
//     used, and a tag of an earlier call never passes for one of this call.
//     At 2^31 - 1 the same kernel zeroes the tags and starts again at 1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "segchain.cuh"

namespace {

using segchain::Pack;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// Blocks an SM should hold: bounds the registers to 64 a thread, which the
// kernel fills without spilling. Measured on an H100, four resident blocks
// sum a long stream a fifth faster than the two that the compiler's own
// choice of 95 registers leaves room for, and than five blocks that spill.
constexpr int MIN_BLOCKS = 4;
constexpr int MAX_HOPS = 8;  // tiles a look-back goes back before it defers to the levels

struct Shape {
  int D;        // row width of the stream and of out
  int cw;       // columns of a panel
  int panels;   // ceil(D / cw)
  int rows;     // rows of a tile
  int slices;   // slices of a tile
  int srows;    // rows of a slice (a multiple of 4)
  int sstride;  // floats between slices in shared memory
  int vec;      // floats per cp.async of the stream
  int ovec;     // owners per cp.async at level 0
};

// Floats between slices: at least srows * cw, a multiple of 4 (16-byte
// copies), and such that the threads of a warp, which read one float or four
// each at (slice, columns), fall into different banks.
int slice_stride(int srows, int cw) {
  const int want = ((cw + 3) & ~3) % 32;
  const int have = (srows * cw) % 32;
  return srows * cw + (want - have + 32) % 32;
}

// A level's tiles (counted from P, the most the level can hold) and where
// its carries lie in the scratch buffer: values [2 * tiles, D] at `val`,
// owners [2 * tiles] at `own`, both in floats from the buffer's start and
// 16-byte aligned; `end` is the first float after them. The level of one
// tile is the last and has no carries.
struct Level {
  long long tiles, val, own, end;
};

__host__ __device__ inline Level level_plan(int P, int D, int rows, int level) {
  Level lv;
  long long used = 0;
  int n = P;  // entries the level can hold: below 2^31 at every level
  for (int l = 0;; ++l) {
    const int tiles = n > rows ? (n - 1) / rows + 1 : 1;
    lv.tiles = tiles;
    lv.val = used;
    lv.own = lv.val + ((2LL * tiles * D + 3) & ~3LL);
    lv.end = tiles == 1 ? used : lv.own + ((2LL * tiles + 3) & ~3LL);
    if (l == level || tiles == 1) return lv;
    used = lv.end;
    n = 2 * tiles;
  }
}

// Entries valid at `level`: the live rows at level 0, then two carries for
// every tile that holds a valid entry.
__device__ __forceinline__ int valid_entries(const int32_t* limit, int P, int level,
                                             int rows) {
  int n = limit ? max(0, min(*limit, P)) : P;
  for (int l = 0; l < level; ++l) n = 2 * ((n + rows - 1) / rows);
  return n;
}

__device__ __forceinline__ void zero_cells(float* out, size_t begin, size_t cells, int part,
                                           int parts) {
  const size_t per = (cells + parts - 1) / parts;
  const size_t lo = min(cells, per * part), hi = min(cells, lo + per);
  for (size_t i = lo + threadIdx.x; i < hi; i += THREADS) out[begin + i] = 0.0f;
}

// A tag is one 64-bit word, the call's epoch above an owner, stored and
// loaded whole: whoever reads the epoch of this call reads its owner with it.
typedef unsigned long long Tag;

__device__ __forceinline__ Tag load_now(const Tag* p) {
  return *reinterpret_cast<const volatile Tag*>(p);
}

__device__ __forceinline__ void store_now(Tag* p, int epoch, int owner) {
  *reinterpret_cast<volatile Tag*>(p) = (Tag)(unsigned)epoch << 32 | (unsigned)owner;
}

// V values to V neighbouring columns of a row of out or of the carries, of
// which the first `live` exist: one 16-byte store where rows of D floats
// keep the address aligned, else 8- or 4-byte stores.
template <int V>
__device__ __forceinline__ void store_cols(float* dst, const Pack<V>& x, int live, int D) {
  if (V == 4 && live == 4 && D % 4 == 0) {
    x.store(dst);
  } else if (V == 4 && live == 4 && D % 2 == 0) {
    *reinterpret_cast<float2*>(dst) = make_float2(x.v[0], x.v[1]);
    *reinterpret_cast<float2*>(dst + 2) = make_float2(x.v[2], x.v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (k < live) dst[k] = x.v[k];
    }
  }
}

// One level of the reduction, the tiles `first`, `first + stride`, ... of
// it. Level 0 reads (cot, owners); level l >= 1 reads the carries that level
// l - 1 wrote, which may have been written during this launch: every read of
// src and own goes through cp.async, never through the read-only path.
// `last` marks the level of one tile, whose first and last runs go to out
// instead of to carries. At level 0 the block also zeroes share `first` of
// `stride` of the rows of out outside the owners' range. A walking thread
// carries V neighbouring columns (4 where cw is a multiple of 4, else 1).
template <int V>
__device__ void run_level(const float* src, const int32_t* own, int n, int level,
                          int num_rows, const Shape& sh, int tiles, bool last,
                          float* carry_val, int32_t* carry_own, float* __restrict__ out,
                          int first, int stride, Tag* tags, int epoch, float* smem) {
  float* tile = smem;                           // slices x sstride
  float* hval = tile + sh.slices * sh.sstride;  // slices x cw
  float* tval = hval + sh.slices * sh.cw;       // slices x cw
  // the owner before the tile sits just before the tile's owners
  int* s_own = reinterpret_cast<int*>(tval + sh.slices * sh.cw) + 4;  // rows
  int* hown = s_own + sh.rows;                                        // slices
  int* town = hown + sh.slices;
  int* single = town + sh.slices;
  unsigned* begins = reinterpret_cast<unsigned*>(single + sh.slices);  // 2
  int* gap_lo = reinterpret_cast<int*>(begins + 2);                    // rows
  int* gap_n = gap_lo + sh.rows;     // rows
  int* n_gaps = gap_n + sh.rows;     // 1
  int* ends_own = n_gaps + 1;        // 2: owners of the tile's first and last run (-1: none)
  int* back = ends_own + 2;          // 3: a look-back's first tile, whether it starts
                                     //    with that tile's last run, whether it defers

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = sh.D, cw = sh.cw, S = sh.srows;
  const int ovec = level ? 4 : sh.ovec;
  bool zeroed = level != 0;
  auto zero_outside = [&]() {
    // Rows before the first and after the last owner: one share a block.
    const int lo = n > 0 ? max(0, min(own[0], num_rows)) : num_rows;
    const int hi = n > 0 ? max(lo, min(own[n - 1] + 1, num_rows)) : num_rows;
    zero_cells(out, 0, (size_t)lo * D, first, stride);
    zero_cells(out, (size_t)hi * D, (size_t)(num_rows - hi) * D, first, stride);
    zeroed = true;
  };

  // A tile of the first level whose carries are written but not published:
  // `before` is the owner of the row before the tile, `head` and `tail` the
  // owners of its first and last run (tail -1: the tile is one run), `ends`
  // whether the stream ends with it.
  struct Pending {
    int item, t, c0, cwa, before, head, tail;
    bool ends, some;
  } pend = {};
  // Publish the tile's carries, then write the runs that this tile sees end
  // (see the note on looking back at the top). Called by the whole block,
  // while the next tile's copies fly.
  auto finish = [&](const Pending& q) {
    const int panel = q.item % sh.panels, t = q.t;
    __threadfence();
    __syncthreads();
    const bool joins = q.before >= 0 && q.head == q.before;  // the first run began earlier
    const bool closes = q.tail >= 0 || q.ends;               // and ends in this tile
    if (tid == 0) {
      store_now(tags + 1 + 2 * q.item, epoch, q.head);
      store_now(tags + 2 + 2 * q.item, epoch, q.tail);
      back[0] = -1;
      if (t > 0 && (!joins || closes)) {
        // The run of `before` ends with tile t - 1 or in this tile: find the
        // tile it began in. A tile's tag is read until it is this call's.
        auto owner = [&](int tile, int which) {
          Tag w;
          do {
            w = load_now(tags + 1 + 2 * (tile * sh.panels + panel) + which);
          } while ((int)(w >> 32) != epoch);
          return (int)(unsigned)w;
        };
        int k = t - 1, from_tail = 0, defer = 0;
        for (int hops = 0;; ++hops) {
          if (owner(k, 1) >= 0) {
            from_tail = 1;  // tile k is cut: the run begins with its last run
            break;
          }
          if (k == 0) break;
          const int last_run = owner(k - 1, 1);
          if ((last_run >= 0 ? last_run : owner(k - 1, 0)) != q.before) break;
          if (hops == MAX_HOPS) {
            defer = 1;
            store_now(tags, epoch, 0);
            break;
          }
          --k;
        }
        __threadfence();  // the carries behind the tags
        back[0] = k, back[1] = from_tail, back[2] = defer;
      }
    }
    __syncthreads();
    if (tid < (q.cwa + V - 1) / V) {
      const int col = q.c0 + tid * V, some = min(V, q.c0 + q.cwa - col);
      auto carry = [&](int entry) {  // an entry's values for these columns, from L2
        Pack<V> x;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          x.v[k] = k < some ? __ldcg(carry_val + (size_t)entry * D + col + k) : 0.0f;
        }
        return x;
      };
      if (back[0] >= 0 && !back[2] && q.before < num_rows) {
        Pack<V> sum = carry(2 * back[0] + back[1]);
        for (int k = back[0] + 1; k < t; ++k) sum.add(carry(2 * k));
        if (joins) sum.add(carry(2 * t));
        store_cols<V>(out + (size_t)q.before * D + col, sum, some, D);
      }
      if (!joins && closes && q.head < num_rows) {
        store_cols<V>(out + (size_t)q.head * D + col, carry(2 * t), some, D);
      }
      if (q.tail >= 0 && q.ends && q.tail < num_rows) {
        store_cols<V>(out + (size_t)q.tail * D + col, carry(2 * t + 1), some, D);
      }
    }
  };

  const int groups = cw / V;  // column groups of a panel
  const int s = tid / groups, d = tid % groups * V;
  const int items = tiles * sh.panels;
  // Tiles look back where the stream is short for the grid (at most two
  // valid tiles a block): there the carry levels would cost as much as the
  // first level, while on a long stream the look-back's fences and polls
  // cost more than the levels save. Without it the levels take every carry.
  const bool look_back =
      level == 0 && !last && ((n + sh.rows - 1) / sh.rows) * sh.panels <= 2 * stride;
  if (level == 0 && !last && !look_back && first == 0 && tid == 0) store_now(tags, epoch, 0);
  for (int item = first; item < items; item += stride) {
    const int t = item / sh.panels, panel = item % sh.panels;
    const int r0 = t * sh.rows;
    if (r0 >= n) break;
    const int rv = min(sh.rows, n - r0);
    const int c0 = panel * cw, cwa = min(cw, D - c0);
    if (tid == 0) *n_gaps = 0, begins[0] = 0, begins[1] = 0;

    // The tile's owners and rows into shared memory, all copies in flight
    // at once. A warp takes whole spans (lanes on neighbouring pieces), so
    // that the index arithmetic is paid once a span, not once a copy.
    for (int i = tid * ovec; i < rv; i += THREADS * ovec) {
      if (i + ovec <= rv) {
        segchain::cp_async(s_own + i, own + r0 + i, ovec);
      } else {
        for (int k = i; k < rv; ++k) segchain::cp_async(s_own + k, own + r0 + k, 1);
      }
    }
    if (tid == 0 && r0 > 0) segchain::cp_async(s_own - 1, own + r0 - 1, 1);
    if (sh.panels == 1) {
      // cw == D: a slice is one contiguous span of srows * D floats.
      const float* g = src + (size_t)r0 * D;
      const int valid = rv * D, span = S * D;
      for (int sl = warp; sl * span < valid; sl += WARPS) {
        const float* from = g + sl * span;
        float* to = tile + sl * sh.sstride;
        const int live = min(span, valid - sl * span);  // floats of the slice that exist
        const int whole = live / sh.vec * sh.vec;
        for (int e = lane * sh.vec; e < whole; e += 32 * sh.vec) {
          segchain::cp_async(to + e, from + e, sh.vec);
        }
        if (lane < live - whole) segchain::cp_async(to + whole + lane, from + whole + lane, 1);
      }
    } else {
      // a span is one row's cwa columns; vec divides D and cw, so cwa too
      for (int i = warp; i < rv; i += WARPS) {
        const float* from = src + (size_t)(r0 + i) * D + c0;
        float* to = tile + (i / S) * sh.sstride + (i % S) * cw;
        for (int j = lane * sh.vec; j < cwa; j += 32 * sh.vec) {
          segchain::cp_async(to + j, from + j, sh.vec);
        }
      }
    }
    segchain::cp_async_commit();
    if (!zeroed) zero_outside();  // while the copies fly
    if (pend.some) {              // and so the tile before, of this block
      finish(pend);
      pend.some = false;
    }
    segchain::cp_async_wait<0>();
    __syncthreads();
    const int before = r0 > 0 ? s_own[-1] : -1;  // the owner of the row before the tile
    if (tid == 0) ends_own[1] = -1;

    if (level == 0) {
      // Output rows that the owners step over inside this tile (or between
      // the tile before and this one): listed, then zeroed a warp a gap.
      for (int i = tid; i < rv; i += THREADS) {
        if (r0 + i == 0) continue;
        const int lo = max(s_own[i - 1] + 1, 0), hi = min(s_own[i], num_rows);
        if (hi > lo) {
          const int k = atomicAdd(n_gaps, 1);
          gap_lo[k] = lo;
          gap_n[k] = hi - lo;
        }
      }
      __syncthreads();
      for (int k = warp; k < *n_gaps; k += WARPS) {
        float* dst = out + (size_t)gap_lo[k] * D + c0;
        for (int cell = lane; cell < gap_n[k] * cwa; cell += 32) {
          dst[(size_t)(cell / cwa) * D + cell % cwa] = 0.0f;
        }
      }
    }

    // Walk: rows of slice s in order, columns c0 + d .. c0 + d + V.
    const bool active = s < sh.slices && d < cwa;
    const int live = min(V, cwa - d);  // columns of this thread that exist
    float* mine = out + c0 + d;
    if (active) {
      const int i0 = s * S, i1 = min(i0 + S, rv);
      const float* col = tile + s * sh.sstride + d;
      int cur = -1, head = -1;
      bool one = true;
      Pack<V> acc = {}, hv = {};
      // four rows a step (a slice has a multiple of 4), so that their
      // loads are in flight together; rows past i1 count as absent
      for (int i = i0; i < i1; i += 4) {
        const int4 o4 = *reinterpret_cast<const int4*>(s_own + i);
        const int os[4] = {o4.x, o4.y, o4.z, o4.w};
        Pack<V> vs[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) vs[k] = Pack<V>::load(col + (i + k - i0) * cw);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int o = i + k < i1 ? os[k] : -1;
          if (o < 0) continue;  // an absent carry
          if (o == cur) {
            acc.add(vs[k]);
            continue;
          }
          if (cur < 0) {
            head = o;
          } else if (one) {
            hv = acc;
            one = false;
          } else if (cur < num_rows) {
            store_cols<V>(mine + (size_t)cur * D, acc, live, D);
          }
          cur = o;
          acc = vs[k];
        }
      }
      hv.store(hval + s * cw + d);
      acc.store(tval + s * cw + d);
      if (d == 0) {
        hown[s] = head;
        town[s] = cur;
        single[s] = one;
        // the owner before the slice: carries are absent one at a time
        int prev = s > 0 ? s_own[i0 - 1] : -1;
        if (prev < 0 && s > 0) prev = s_own[i0 - 2];
        if (head >= 0 && !(one && prev == head)) segchain::mark_chain_begin(begins, s);
      }
    }
    __syncthreads();

    // Join the slices' first and last runs. The chain that holds the
    // tile's first row is the tile's first run, the one that ends the last
    // slice its last run; every other chain is complete.
    if (active && hown[s] >= 0) {
      const bool end = s == sh.slices - 1 || hown[s + 1] < 0;
      float* cv = carry_val + (size_t)(2 * t) * D + c0 + d;
      // every panel writes the carries' owners (the same values), so that a
      // look-back needs only its own panel's flags
      const bool names = d == 0;
      auto put = [&](int which, int g, const Pack<V>& x) {  // 0 first, 1 last run, 2 complete
        if (which == 2 || last) {
          if (g < num_rows) store_cols<V>(mine + (size_t)g * D, x, live, D);
        } else {
          store_cols<V>(cv + (size_t)which * D, x, live, D);
          if (names) carry_own[2 * t + which] = g, ends_own[which] = g;
        }
      };
      if (!single[s]) {
        Pack<V> sum = Pack<V>::load(hval + s * cw + d);
        bool at_start = s == 0;
        if (s > 0 && town[s - 1] == hown[s]) {
          const int k = segchain::chain_start(begins, s - 1);
          Pack<V> prior = segchain::chain_sum<V>(tval + d, cw, k, s - 1);
          prior.add(sum);
          sum = prior;
          at_start = k == 0 && single[0];
        }
        put(at_start ? 0 : 2, hown[s], sum);
      }
      if (end || town[s] != hown[s + 1]) {
        const int k = segchain::chain_start(begins, s);
        const bool at_start = k == 0 && single[0];
        put(at_start ? 0 : (end ? 1 : 2), town[s], segchain::chain_sum<V>(tval + d, cw, k, s));
        if (at_start && end && names && !last) carry_own[2 * t + 1] = -1;
      }
    }
    __syncthreads();  // the next tile overwrites shared memory
    if (look_back) {
      pend.item = item, pend.t = t, pend.c0 = c0, pend.cwa = cwa, pend.before = before;
      pend.head = ends_own[0], pend.tail = ends_own[1], pend.ends = r0 + rv == n;
      pend.some = true;
    }
  }
  if (!zeroed) zero_outside();
  if (pend.some) finish(pend);
}

// Level `level` over the whole grid; with `inline_rest`, the block that
// finishes last (an integer ticket, set back to 0 for the next call) goes on
// through the remaining levels.
template <int V>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) segsum_kernel(
    const float* __restrict__ cot, const int32_t* __restrict__ owners,
    const int32_t* __restrict__ limit, int P, int level, int inline_rest, int num_rows,
    Shape sh, float* scratch, int32_t* ticket, Tag* flags, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int is_last_block;
  // This call's epoch, raised by bump_epoch before level 0 (launches after a
  // level's last tile find it unchanged), and the look-back's tags after it.
  const int epoch = static_cast<int>(static_cast<unsigned>(flags[0]));
  Tag* tags = flags + 1;
  int first = blockIdx.x, stride = gridDim.x;
  // Entries valid at the level before and at this one.
  int below = level ? valid_entries(limit, P, level - 1, sh.rows) : 0;
  int n = level ? 2 * ((below + sh.rows - 1) / sh.rows) : valid_entries(limit, P, 0, sh.rows);
  for (;; ++level, below = n, n = 2 * ((n + sh.rows - 1) / sh.rows)) {
    // The level whose valid entries fit one tile is the last: it may come
    // sooner than the level that P allows for, and the launches after it
    // find nothing to do.
    if (level > 0 && below <= sh.rows) return;
    // The carry levels run only if a look-back of this call deferred to them.
    if (level > 0 && (int)(load_now(tags) >> 32) != epoch) return;
    const bool last = n <= sh.rows;
    const Level lv = level_plan(P, sh.D, sh.rows, level);
    const float* src = cot;
    const int32_t* own = owners;
    if (level > 0) {
      const Level from = level_plan(P, sh.D, sh.rows, level - 1);
      src = scratch + from.val;
      own = reinterpret_cast<const int32_t*>(scratch + from.own);
    }
    run_level<V>(src, own, n, level, num_rows, sh, static_cast<int>(lv.tiles), last,
              scratch + lv.val, reinterpret_cast<int32_t*>(scratch + lv.own), out, first,
              stride, tags, epoch, smem);
    if (!inline_rest || last) return;
    if (stride > 1) {
      __threadfence();  // this block's carries, before its ticket
      __syncthreads();
      if (threadIdx.x == 0) {
        is_last_block = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
        if (is_last_block) *ticket = 0;
      }
      __syncthreads();
      if (!is_last_block) return;
      __threadfence();  // the other blocks' carries, after the last ticket
      first = 0;
      stride = 1;
    } else {
      __syncthreads();  // this block's own carries of the level before
    }
  }
}

// Raises the epoch in flags[0] by one before a call's first level. Where it
// would pass 2^31 - 1, the tags (flags[1 .. words)) are zeroed and the epoch
// starts again at 1, so that no tag left by an earlier call carries it.
__global__ void bump_epoch(Tag* flags, long long words) {
  __shared__ unsigned now;
  if (threadIdx.x == 0) now = static_cast<unsigned>(flags[0]);
  __syncthreads();
  const bool wrap = now >= 0x7fffffffu;
  if (wrap) {
    for (long long i = 1 + threadIdx.x; i < words; i += blockDim.x) flags[i] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) flags[0] = wrap ? 1u : now + 1u;
}

// Every level of the reduction, one launch a level until a launch takes the
// rest with it. Returns a cudaError_t.
template <int V>
int launch_levels(const void* cot, const void* owners, const void* limit, int P, int num_rows,
                  const Shape& sh, size_t smem, int inline_items, void* scratch, void* ticket,
                  void* flags, long long flag_words, void* out, void* stream) {
  // Blocks that the card holds at once, asked once per shared-memory size
  // (the cards of one host are taken to be alike). A call's first launch at
  // a size asks; a CUDA graph is captured after a call at its sizes, so
  // these queries never run first inside a capture.
  static int sms = 0;
  static size_t seen_smem[16];
  static int seen_resident[16];
  static int n_seen = 0;
  cudaError_t err = cudaSuccess;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int resident = 0;
  for (int i = 0; i < n_seen; ++i) {
    if (seen_smem[i] == smem) resident = seen_resident[i];
  }
  if (!resident) {
    static size_t allowed = 48 * 1024;  // what a kernel gets without asking
    if (smem > allowed) {
      err = cudaFuncSetAttribute(segsum_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = smem;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, segsum_kernel<V>, THREADS,
                                                        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_seen < 16) {
      seen_smem[n_seen] = smem;
      seen_resident[n_seen++] = resident;
    }
  }
  if (resident < 1 || sms < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long cap = static_cast<long long>(sms) * resident;

  bump_epoch<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<Tag*>(flags),
                                                                  flag_words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  for (int level = 0;; ++level) {
    const Level lv = level_plan(P, sh.D, sh.rows, level);
    long long blocks = lv.tiles * sh.panels;
    if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    if (level == 0) {
      // enough blocks to share out the zero rows of a wide, sparse output
      const long long cells = static_cast<long long>(num_rows) * sh.D;
      blocks = blocks > (cells >> 13) ? blocks : (cells >> 13);
    }
    if (blocks > cap) blocks = cap;
    const bool last = lv.tiles == 1;
    const bool inline_rest =
        !last && level_plan(P, sh.D, sh.rows, level + 1).tiles * sh.panels <= inline_items;
    segsum_kernel<V><<<static_cast<int>(blocks), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cot), static_cast<const int32_t*>(owners),
        static_cast<const int32_t*>(limit), P, level, inline_rest, num_rows, sh,
        static_cast<float*>(scratch), static_cast<int32_t*>(ticket),
        static_cast<Tag*>(flags), static_cast<float*>(out));
    err = cudaGetLastError();
    if (err != cudaSuccess || last || inline_rest) return static_cast<int>(err);
  }
}

}  // namespace

extern "C" {

const char* sgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers; limit may be null. The tile shape (cw
// columns, `rows` rows, `slices` slices), `vec` (floats per copy of cot: 1, 2
// or 4) and `ovec` (owners per copy: 1 or 4) come from the wrapper, which
// also allocates `scratch`, the carries of every level (scratch_floats
// floats, 16-byte aligned), and keeps `ticket`, one int32 that is 0 between
// calls, and `flags`, flag_words >= 2 + 2 x tiles x panels 64-bit words
// (zeros at first): the epoch, then the tags. Launches the epoch's bump,
// then one kernel a level; a level of `inline_items` tiles or fewer
// (counted from P) runs inside the launch before it. Nothing of a call is
// decided on the host from an earlier call, so a CUDA graph may capture it.
// Returns a cudaError_t.
int sgt_segsum(const void* cot, const void* owners, const void* limit, int P, int D,
               int num_rows, int cw, int rows, int slices, int vec, int ovec,
               int inline_items, void* scratch, long long scratch_floats, void* ticket,
               void* flags, long long flag_words, void* out, void* stream) {
  if (num_rows <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const int v = cw % 4 ? 1 : 4;  // columns a walking thread carries
  if (P < 0 || cw <= 0 || cw > D || slices <= 0 || slices > 64 || slices * (cw / v) > THREADS || rows <= 0 ||
      rows % slices || (rows / slices) % 4 || (vec != 1 && vec != 2 && vec != 4) ||
      (ovec != 1 && ovec != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape sh;
  sh.D = D;
  sh.cw = cw;
  sh.panels = (D + cw - 1) / cw;
  sh.rows = rows;
  sh.slices = slices;
  sh.srows = rows / slices;
  sh.sstride = slice_stride(sh.srows, cw);
  sh.vec = vec;
  sh.ovec = ovec;
  if (sh.panels > 1 && (cw % vec || D % vec)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (slices * sh.sstride + 2 * slices * cw) +
                      sizeof(int) * (4 + 3 * rows + 3 * slices + 2 + 1 + 5);
  if (level_plan(P, D, rows, INT32_MAX).end > scratch_floats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items = level_plan(P, D, rows, 0).tiles * sh.panels;
  if (flag_words < 2 + 2 * items) return static_cast<int>(cudaErrorInvalidValue);

  return v == 4 ? launch_levels<4>(cot, owners, limit, P, num_rows, sh, smem, inline_items,
                                   scratch, ticket, flags, flag_words, out, stream)
                : launch_levels<1>(cot, owners, limit, P, num_rows, sh, smem, inline_items,
                                   scratch, ticket, flags, flag_words, out, stream);
}

}  // extern "C"
