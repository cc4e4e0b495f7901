// Min s-t cut of a 4-connected seam grid by lock-step push-relabel, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces simplepanorama_tpu/ops/maxflow.py::_mincut_kernel (the Pallas
// kernel behind grid_mincut_pallas), which the seam graph cut runs on
// grids of up to 1.2M cells. What it computes is the same: t-links folded
// into a signed excess clipped to the incident capacity sum + 1; outer
// rounds of `inner_iters` push/relabel phases (4 directions each, in the
// order right, left, down, up, every direction lock-step); then one
// global-relabel BFS (distance to the nearest sink through positive
// residual edges) that doubles as the termination test. The output is the
// source side: node cells that cannot reach a sink.
//
// What bounds it on this card. Not bytes or operations (a 640x640 seam
// block needs ~0.05 ms of either): latency. The first port ran every push
// direction, relabel and BFS scan as its own whole-grid launch (~13k
// launches per solve), read a flag back to the host after every BFS pass
// (~1.5k reads), and its column scans read with a stride of W, one warp
// per line; the BFS was ~73% of its device time.
//
// Design (shared pieces in mincut_tile.cuh and mincut_bfs.cuh). The TPU
// kernel keeps the whole grid in VMEM for one launch; here the whole grid
// is kept in the shared memory of all SMs at once:
// * The grid is cut into as many tiles as CTAs can be co-resident (one per
//   SM), TH x TW cells each with a 1-cell halo: c[4], e, h and a flow
//   plane, ~109 KB per CTA at a 640x640 block (50x64 tiles, 130 CTAs).
//   One cooperative launch per outer round loads the tiles (16-byte
//   cp.async), runs the push phases and the BFS with the state resident,
//   and stores it; the host reads one flag after it: one host read per
//   BFS.
// * Push phase, lock-step over the whole grid as the plain version: the
//   four sub-steps inside a tile as there; flows that leave a tile go out
//   through device memory (an inflow plane per direction) and are added to
//   the neighbour's edge cells after its four sub-steps, before its
//   relabel; then each tile publishes its edge heights and reads its halo
//   heights. A flow that crosses a tile edge is thus applied after the
//   phase's four sub-steps rather than inside them: the receiving cell
//   pushes less in that phase, which is still a valid push-relabel
//   schedule, and every flow is applied before any cell relabels, so no
//   label goes invalid. The tile's cells live in registers for the whole
//   push block (push_block): each thread holds a column strip of the
//   rows of its band, flows pass down a strip in registers, along a row
//   by shuffle and between warps through shared memory; the strip's
//   height follows the tile (a kernel for each of a few heights). No grid
//   barrier between phases: each tile waits only on its four neighbours'
//   phase words (release and acquire), before it reads their flows and
//   before it reads their heights, so a tile runs as far ahead of the
//   tiles it does not touch as its neighbours let it; one copy of the
//   inflow and height planes is enough (push_block says why).
// * BFS: the bit-parallel level BFS of mincut_bfs.cuh on each resident
//   tile, halo distances read from the neighbours' published edges, driven
//   by events and not by grid rounds (bfs_events). Each tile runs once on
//   its sinks, then again whenever a neighbour published a lower distance
//   on their shared edge: a tile whose run lowered an edge distance
//   publishes it, fences, and asks the neighbour on that side for a run.
//   A run owed or under way is counted in a device word; it is counted
//   for a neighbour before the asking run uncounts itself, so the word
//   reads 0 only once no run is owed anywhere, and then one grid barrier
//   ends the BFS. With lock-step rounds every round lasted as long as its
//   slowest tile, and a wave crossed one tile per round: ~12 rounds a BFS
//   on the 640x640 block, the slowest tile's levels summed over them 2-3x
//   the longest distance. Distances are exact either way (mincut_bfs.cuh:
//   every value read is a real path's length and a tile that saw its
//   halo's last drop has run since), so the pushes see the same heights.
//   Spinning on other CTAs is safe only because a cooperative launch
//   makes every tile's CTA resident; the tiled route, whose BFS tiles
//   outnumber its CTAs, keeps the rounds of bfs_rounds. The runs keep the
//   tile's distances as ints in the push's scratch plane, so a look at a
//   distance inside a BFS level is one shared load.
// * A grid whose tiles cannot all be resident at once (over ~0.8-0.9M
//   cells on an H100), or whose bands would pass the tallest strip (16
//   rows), takes the tiled solver of csrc/mincut_tiled.cu instead
//   (last_stats["resident"] says which ran).
//
// Measured (H100 80GB HBM3, 700 W, in turns with the earlier versions):
// 640x640 seam block, 47 outer rounds, 50 launches, 48 host reads; the
// first port 133-134 ms a solve; lock-step BFS rounds 49.4 ms, of which
// 21.5 ms in push phases (two grid barriers each, ~15 us a phase) and
// 26.4 ms in 551 BFS rounds (~48 us each), by the device clock at grid
// barriers; BFSs driven by events 43.5 ms, the push phases the same and
// the BFSs 20.3 ms in ~22k tile runs. A BFS is then a chain of ~15
// dependent tile runs of ~30 us, nearly all of it the tile's levels: how
// a tile is woken (spinning, backoff, fences) moved nothing. Resident
// tiles beat the tiled solver up to the largest block that fits
// (1.19-1.34x at 0.41-0.77M cells, with the lock-step BFS).
//
// Built with -fmad=false so every multiply and add rounds like the plain
// PyTorch version (ops/maxflow.py::grid_mincut_ref).

#include "mincut_tile.cuh"

namespace {

using namespace spt;

struct ResGeom {
  int TH, TW, nty, ntx;
  int RB;   // rows of a band of the push phase's column strips
};

struct Inflow {
  float* f[4];   // flow that moved in direction k into a tile's edge cell
};

// edge cell j of the tile's n_edge = TW * min(TH, 2) + 2 * max(TH - 2, 0)
// interior cells on its border, each once: its (ly, lx) in smem
__device__ __forceinline__ int n_edge(const PushTile& T) {
  return T.TW * min(T.TH, 2) + 2 * max(T.TH - 2, 0);
}

__device__ __forceinline__ void edge_cell(const PushTile& T, int j, int* ly, int* lx) {
  if (j < T.TW) { *ly = 1; *lx = CX + j; return; }
  j -= T.TW;
  if (T.TH > 1) {
    if (j < T.TW) { *ly = T.TH; *lx = CX + j; return; }
    j -= T.TW;
  }
  *ly = 2 + j / 2;
  *lx = (j & 1) ? CX + T.TW - 1 : CX;
}

__device__ __forceinline__ bool in_grid(const PushTile& T, const State& S, int i,
                               long* g) {
  int y = T.y0 + i / T.SP - 1, x = T.x0 + i % T.SP - CX;
  if (y < 0 || y >= S.H || x < 0 || x >= S.W) return false;
  *g = (long)y * S.P + x;
  return true;
}

// write the heights of the tile's edge cells to device memory
__device__ __forceinline__ void publish_edges(const PushTile& T, const State& S) {
  for (int j = threadIdx.x; j < n_edge(T); j += blockDim.x) {
    int ly, lx;
    edge_cell(T, j, &ly, &lx);
    int i = ly * T.SP + lx;
    long g;
    if (in_grid(T, S, i, &g)) __stcg(S.h + g, T.h[i]);
  }
}

// Kernel 1's own flag slots, ones the shared flags leave free: BFS tile
// runs, summed over CTAs and BFSs; push phases run (tile 0's); checks of
// a neighbour's phase word (one per tile, phase, neighbour and hand-off),
// and those that found the neighbour not yet there.
constexpr int F_TILE_RUNS = 7;
constexpr int F_PUSH_PHASES = 12;
constexpr int F_PUSH_CHECKS = 13;
constexpr int F_PUSH_WAITS = 14;
static_assert(F_LEVELS < F_TILE_RUNS && F_TILE_RUNS < F_PUSH_NS,
              "F_TILE_RUNS lies between the shared flags");
static_assert(F_BFS_NS + 2 <= F_PUSH_PHASES && F_PUSH_WAITS < F_COUNT,
              "the push counters lie past the shared flags");

// The most tiles the resident route takes (one per SM), and the device
// words of its event-driven BFS, after the rest of the work buffer: the
// runs owed, then the runs asked of each tile. Then each tile's phase
// word, one to a 128-byte line (PHASE_WORDS ints from a line boundary),
// and after the last tile's the u64 time at which the grid's push block
// ended.
constexpr int RES_MAX_TILES = 1023;
constexpr long EVENT_WORDS = RES_MAX_TILES + 1;
constexpr int WORD_STRIDE = 32;
constexpr long PHASE_WORDS = (long)RES_MAX_TILES * WORD_STRIDE + WORD_STRIDE;

// ints of shared scratch the resident kernel takes past its BFS tile
constexpr int RES_SCRATCH_INTS = 2;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// one float from device memory into shared memory, in flight until
// cp_async_wait_all
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(gmem));
}

// a neighbour's height across a lane: the next lane's by shuffle, or at a
// group's side the one in shared memory
__device__ __forceinline__ float across(float shuffled, bool at_side,
                                        const float* slot) {
  return at_side ? *slot : shuffled;
}

// v, which the compiler may not assume to be loop-invariant: addresses
// built from it are rebuilt where they are used
__device__ __forceinline__ long opaque(long v) {
  asm volatile("" : "+l"(v));
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Write the distances (`dist`, ints in the tile's smem layout) of the
// tile's edge cells that dropped below what the tile last published to
// device memory as heights, then fence. Returns, block-uniform, the sides
// (bit 0 top, 1 bottom, 2 left, 3 right) on which one did; *sm is a shared
// scratch int.
__device__ __forceinline__ int publish_edge_drops(const PushTile& T,
                                                  const State& S,
                                                  const int* dist, int* sm) {
  if (threadIdx.x == 0) *sm = 0;
  __syncthreads();
  int sides = 0;
  for (int j = threadIdx.x; j < n_edge(T); j += blockDim.x) {
    int ly, lx;
    edge_cell(T, j, &ly, &lx);
    int i = ly * T.SP + lx;
    long g;
    const float h = dist[i] < INF_I ? (float)dist[i] : INF_F;
    if (!in_grid(T, S, i, &g) || !(h < __ldcg(S.h + g))) continue;
    __stcg(S.h + g, h);
    sides |= (ly == 1 ? 1 : 0) | (ly == T.TH ? 2 : 0) | (lx == CX ? 4 : 0) |
             (lx == CX + T.TW - 1 ? 8 : 0);
  }
  __threadfence();
  sides = __reduce_or_sync(FULL, sides);
  if ((threadIdx.x & 31) == 0 && sides) atomicOr(sm, sides);
  __syncthreads();
  return *sm;
}

// One BFS over the resident tiles, one tile per CTA, driven by events:
// run(first) works the CTA's tile once (the first time on its sinks) and
// returns the sides on which it published a lower edge distance, block-
// uniform. A run on those sides' neighbours is then owed. ev[0] counts
// the runs owed or under way (every tile's first run on entry), ev[1 + t]
// those asked of tile t and not yet taken (0 on entry); a run is counted
// for a neighbour before the asking run uncounts itself, so ev[0] reads 0
// only once no run is owed anywhere. A tile runs at most n_pass times;
// a run asked beyond that is uncounted unrun. Thread 0 waits on the two
// words with a backoff; *sm is a shared scratch int. Returns the CTA's
// runs, after which the caller's grid barrier ends the BFS.
template <class RunFn>
__device__ __forceinline__ int bfs_events(int* ev, const ResGeom& G,
                                          int n_pass, int* sm, RunFn run) {
  const int t = blockIdx.x, ty = t / G.ntx, tx = t % G.ntx;
  const int nb[4] = {ty > 0 ? t - G.ntx : -1,
                     ty + 1 < G.nty ? t + G.ntx : -1,
                     tx > 0 ? t - 1 : -1, tx + 1 < G.ntx ? t + 1 : -1};
  int* const owed = ev;
  int* const asked = ev + 1;
  int runs = 0, taken = 1;   // the first run, counted on entry
  for (;;) {
    const int sides = runs < n_pass ? run(runs++ == 0) : 0;
    if (threadIdx.x == 0) {
      __threadfence();   // the edges before the asks
      #pragma unroll
      for (int k = 0; k < 4; ++k)
        if (((sides >> k) & 1) && nb[k] >= 0) atomicAdd(owed, 1);
      __threadfence();   // counted before asked
      #pragma unroll
      for (int k = 0; k < 4; ++k)
        if (((sides >> k) & 1) && nb[k] >= 0) atomicAdd(asked + nb[k], 1);
      atomicSub(owed, taken);
      unsigned ns = 32;
      for (;;) {
        if (ld_acquire(asked + t) != 0) {
          taken = atomicExch(asked + t, 0);   // only this thread takes
          break;
        }
        if (ld_acquire(owed) == 0) {
          taken = 0;
          break;
        }
        __nanosleep(ns);
        if (ns < 512) ns *= 2;
      }
      __threadfence();   // the neighbours' edges after their asks
      *sm = taken;
    }
    __syncthreads();
    const bool done = *sm == 0;
    __syncthreads();
    if (done) return runs;
  }
}

// The push/relabel phase of one interior cell, as push_substeps and
// relabel compute it (the same float operations in the same order).
__device__ __forceinline__ float push_flow(float e, float c, float h,
                                           float nb) {
  return (e > 0.0f && h < INF_F && h == nb + 1.0f && c > 0.0f) ? fminf(e, c)
                                                               : 0.0f;
}

// the height a cell lifts to; nb: the heights right, left, below, above
__device__ __forceinline__ float lift(float hp, float e, float c0, float c1,
                                      float c2, float c3, float n0, float n1,
                                      float n2, float n3) {
  if (!(e > 0.0f)) return hp;
  const float c[4] = {c0, c1, c2, c3}, nb[4] = {n0, n1, n2, n3};
  float min_h = INF_F;
  bool adm = false;
  #pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool has_cap = c[k] > 0.0f;
    min_h = fminf(min_h, has_cap ? nb[k] : INF_F);
    adm = adm || (has_cap && hp == nb[k] + 1.0f);
  }
  return (!adm && min_h < INF_F) ? min_h + 1.0f : hp;
}

// Floats of shared scratch the push block lays over the tile's c and e
// planes: flows and heights that cross between warps (see push_block).
__host__ __device__ __forceinline__ long push_scratch_floats(int TH, int TW,
                                                             int RB) {
  const int nwb = TW / 32, nbu = (TH + RB - 1) / RB;
  return 6L * nwb * TH + 4L * nbu * TW;
}

// The push block of a resident launch: `phases` push/relabel phases, the
// tile's cells in registers. Warp w works the 32 columns 32 (w % nwb) ..
// of the band of rows RB (w / nwb) ..: lane l holds the cells of one
// column of the band, a strip of up to R, its c[4], e and h. A sub-step's
// flows pass down the strip in registers and along a row by shuffle; the
// ones that cross to another warp go through shared memory (FX, FY) and
// are added after a barrier, before the next sub-step; the ones that
// leave the tile go to the inflow planes. Heights that border another
// warp (HX, by phase parity, and HY) are rewritten once a phase.
//
// Between tiles no grid barrier: the tile's phase word (pw) reads 2p + 1
// once its phase-p flows are out and 2p + 2 once its phase-p edge heights
// are; it waits for its neighbours' words to read 2p + 1 before it reads
// their flows into its edge cells, and 2p + 2 before it reads their edge
// heights. One copy of each plane is enough: a tile writes phase-(p + 1)
// flows only after it saw its neighbours' phase-p heights, which each
// published only after it read its phase-p inflows; it publishes phase-
// (p + 1) heights only after it saw their phase-(p + 1) flows, written
// after they read its phase-p heights. The last phase's heights are not
// handed over: the BFS publishes its own. Spinning is safe because the
// cooperative launch keeps every tile resident.
//
// Not inlined: compiled into the kernel's body, it left the BFS that
// follows ~6% slower on an H100 (its code unchanged), out of line the BFS
// runs as before.
template <int R>
__device__ __noinline__ void push_block(float* smem, const PushTile& T,
                                           const State& S, const ResGeom& G,
                                           const Inflow& I, int* pw,
                                           int phases) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwb = G.TW >> 5, TH = G.TH, TW = G.TW, RB = G.RB;
  const int nbu = (TH + RB - 1) / RB;   // bands that hold rows
  const int gi = warp % nwb, b = warp / nwb;
  const int col = 32 * gi + lane, r0 = b * RB;
  // rows of this warp's strips (0 for a warp past the last band); the
  // strip's registers past them stay c = 0, e = 0, h = INF and take no flow
  const int nv = b < nbu ? min(RB, TH - r0) : 0;
  const bool last_band = r0 + nv == TH;
  const int x = T.x0 + col, y0 = T.y0 + r0;
  const bool xin = x < S.W;
  const int rows_in = min(nv, S.H - y0);   // strip rows inside the grid
  auto at = [&](int r) { return (1 + r0 + r) * T.SP + CX + col; };

  float* FX = smem;                       // [2][nwb][TH]
  float* FY = FX + 2 * nwb * TH;          // [2][nbu][TW]
  float* HX = FY + 2 * nbu * TW;          // [parity][2][nwb][TH]
  float* HY = HX + 4 * nwb * TH;          // [2][nbu][TW]
  // the flows out of this group's left and right sides at the strip's
  // rows [r]; at the tile's sides they then take the neighbour's inflows
  float* fx_l = FX + gi * TH + r0;
  float* fx_r = FX + (nwb + gi) * TH + r0;
  // the flow out of the top (0) or bottom (1) of band q in this column
  // (at the tile's top and bottom, then the neighbour's inflow)
  auto fy = [&](int d, int q) -> float& {
    return FY[(d * nbu + q) * TW + col];
  };
  // the heights left (0) or right (1) of group q at the strip's rows [r]
  auto hx = [&](int pp, int d, int q) {
    return HX + ((pp * 2 + d) * nwb + q) * TH + r0;
  };
  // the height above (0) or below (1) band q in this column
  auto hy = [&](int d, int q) -> float& {
    return HY[(d * nbu + q) * TW + col];
  };

  float c[4][R], e[R], h[R], hn[R];
  #pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool in = r < nv;
    #pragma unroll
    for (int k = 0; k < 4; ++k) c[k][r] = in ? T.c[k][at(r)] : 0.0f;
    e[r] = in ? T.e[at(r)] : 0.0f;
    h[r] = in ? T.h[at(r)] : INF_F;
    hn[r] = h[r];
  }
  __syncthreads();   // the c and e planes are scratch from here
  if (nv > 0) {      // the first phase's heights around the strip
    #pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nv && lane == 0) hx(0, 0, gi)[r] = T.h[at(r) - 1];
      if (r < nv && lane == 31) hx(0, 1, gi)[r] = T.h[at(r) + 1];
    }
    hy(0, b) = T.h[at(0) - T.SP];
    hy(1, b) = T.h[at(nv - 1) + T.SP];
  }

  // thread k < 4 watches the neighbour above, below, left, right
  const int t = blockIdx.x, ty = t / G.ntx, tx = t % G.ntx;
  int watch = -1;
  if (threadIdx.x == 0 && ty > 0) watch = t - G.ntx;
  if (threadIdx.x == 1 && ty + 1 < G.nty) watch = t + G.ntx;
  if (threadIdx.x == 2 && tx > 0) watch = t - 1;
  if (threadIdx.x == 3 && tx + 1 < G.ntx) watch = t + 1;
  int checks = 0, waits = 0;
  auto release = [&](int mark) {   // after a barrier
    if (threadIdx.x == 0) st_release(pw + (long)t * WORD_STRIDE, mark);
  };
  auto wait_for = [&](int mark) {  // ends with a barrier
    if (watch >= 0) {
      const int* w = pw + (long)watch * WORD_STRIDE;
      ++checks;
      if (ld_acquire(w) < mark) {
        ++waits;
        while (ld_acquire(w) < mark) {
        }
      }
    }
    __syncthreads();
  };

  for (int p = 0; p < phases; ++p) {
    const int pp = p & 1;
    // the strip's column in the device planes, rebuilt every phase so
    // that no per-row address lives across phases
    const long P = opaque((long)S.P);
    const long g0 = (long)y0 * P + x;
    float hu = INF_F, hd = INF_F;   // above the strip, below it
    if (nv > 0) {
      hu = hy(0, b);
      hd = hy(1, b);
    }
    const float* hl_in = hx(pp, 0, gi);
    const float* hr_in = hx(pp, 1, gi);
    // the relabel of strip row r from its values (whole warps call it):
    // the heights beside it by shuffle, or from shared memory at a group's
    // side
    auto lift_row = [&](float hp, float ep, float c0, float c1, float c2,
                        float c3, float h_down, float h_up, int r) {
      const float h_right =
          across(__shfl_down_sync(FULL, hp, 1), lane == 31, hr_in + r);
      const float h_left =
          across(__shfl_up_sync(FULL, hp, 1), lane == 0, hl_in + r);
      return lift(hp, ep, c0, c1, c2, c3, h_right, h_left, h_down, h_up);
    };
    // register arrays are indexed by unrolled loop counters only, so that
    // they stay in registers
#define SPT_DOWN(r) ((r) + 1 < nv ? h[(r) + 1 < R ? (r) + 1 : R - 1] : hd)
#define SPT_UP(r) ((r) > 0 ? h[(r) > 0 ? (r) - 1 : 0] : hu)
#define SPT_LIFT(r)                                                    \
  lift_row(h[r], e[r], c[0][r], c[1][r], c[2][r], c[3][r], SPT_DOWN(r), \
           SPT_UP(r), r)

    if (nv > 0) {
      // sub-step right: the flow into lane 0 from the group on its left
      // is added after the barrier (adding +0 first changes no bit)
      #pragma unroll
      for (int r = 0; r < R; ++r) {
        const float f = push_flow(
            e[r], c[0][r], h[r],
            across(__shfl_down_sync(FULL, h[r], 1), lane == 31, hr_in + r));
        float in = __shfl_up_sync(FULL, f, 1);
        if (lane == 0) in = 0.0f;
        c[0][r] = c[0][r] - f;
        c[1][r] = c[1][r] + in;
        e[r] = e[r] - f + in;
        if (lane == 31 && r < nv) fx_r[r] = f;
      }
      if (lane == 31 && gi == nwb - 1 && x + 1 < S.W) {   // out of the tile
        #pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < rows_in) __stcg(I.f[0] + g0 + r * P + 1, fx_r[r]);
      }
    }
    __syncthreads();
    if (nv > 0) {
      {   // every lane adds, + 0 but at lane 0 (no -0 is left), so that
          // the warp does not diverge before its shuffles
        const bool take = lane == 0 && gi > 0;
        const float* src = fx_r - TH;   // the right side of group gi - 1
        #pragma unroll
        for (int r = 0; r < R; ++r) {
          const float in = take && r < nv ? src[r] : 0.0f;
          c[1][r] = c[1][r] + in;
          e[r] = e[r] + in;
        }
      }
      // sub-step left
      #pragma unroll
      for (int r = 0; r < R; ++r) {
        const float f = push_flow(
            e[r], c[1][r], h[r],
            across(__shfl_up_sync(FULL, h[r], 1), lane == 0, hl_in + r));
        float in = __shfl_down_sync(FULL, f, 1);
        if (lane == 31) in = 0.0f;
        c[1][r] = c[1][r] - f;
        c[0][r] = c[0][r] + in;
        e[r] = e[r] - f + in;
        if (lane == 0 && r < nv) fx_l[r] = f;
      }
      if (lane == 0 && gi == 0 && x > 0) {
        #pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < rows_in) __stcg(I.f[1] + g0 + r * P - 1, fx_l[r]);
      }
    }
    __syncthreads();
    if (nv > 0) {
      {
        const bool take = lane == 31 && gi + 1 < nwb;
        const float* src = fx_l + TH;   // the left side of group gi + 1
        #pragma unroll
        for (int r = 0; r < R; ++r) {
          const float in = take && r < nv ? src[r] : 0.0f;
          c[0][r] = c[0][r] + in;
          e[r] = e[r] + in;
        }
      }
      // sub-step down, top to bottom of the strip; the last row's flow
      // goes to the band below
      float prev = 0.0f, last = 0.0f;
      #pragma unroll
      for (int r = 0; r < R; ++r) {
        const float f = push_flow(e[r], c[2][r], h[r], SPT_DOWN(r));
        c[2][r] = c[2][r] - f;
        c[3][r] = c[3][r] + prev;
        e[r] = e[r] - f + prev;
        prev = r + 1 < nv ? f : 0.0f;
        if (r == nv - 1) last = f;
      }
      fy(1, b) = last;
      if (last_band && T.y0 + TH < S.H && xin)
        __stcg(I.f[2] + g0 + nv * P, last);
    }
    __syncthreads();
    if (nv > 0) {
      if (b > 0) {
        const float in = fy(1, b - 1);
        c[3][0] = c[3][0] + in;
        e[0] = e[0] + in;
      }
      // sub-step up, bottom to top
      float next = 0.0f;
      #pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        const float f = push_flow(e[r], c[3][r], h[r], SPT_UP(r));
        c[3][r] = c[3][r] - f;
        c[2][r] = c[2][r] + next;
        e[r] = e[r] - f + next;
        next = f;
      }
      fy(0, b) = next;
      if (b == 0 && T.y0 > 0 && xin) __stcg(I.f[3] + g0 - P, next);
    }
    __syncthreads();
    release(2 * p + 1);   // every flow that left the tile is out
    if (nv > 0 && !last_band) {
      const float in = fy(0, b + 1);
      #pragma unroll
      for (int r = 0; r < R; ++r) {   // + 0 elsewhere: no -0 is left
        const float add = r == nv - 1 ? in : 0.0f;
        c[2][r] = c[2][r] + add;
        e[r] = e[r] + add;
      }
    }

    // the relabel of every cell whose c and e the neighbours' flows leave
    // as they are, while they arrive
    if (nv > 0) {
      #pragma unroll
      for (int r = 0; r < R; ++r) hn[r] = SPT_LIFT(r);
    }
    // their flows into the tile's edge cells, by direction (right, left,
    // down, up), copied into the slots of the flows that left there, all
    // in flight at once; then those cells' relabel
    wait_for(2 * p + 1);
    if (nv > 0) {
      const bool left = lane == 0 && gi == 0 && x > 0;
      const bool right = lane == 31 && gi == nwb - 1 && x + 1 < S.W;
      const bool top = b == 0 && T.y0 > 0 && xin;
      const bool bottom = last_band && T.y0 + TH < S.H && xin;
      float* side = left ? fx_l : fx_r;
      if (left || right) {
        const float* src = (left ? I.f[0] : I.f[1]) + g0;
        #pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < rows_in) cp_async4(side + r, src + r * P);
      }
      if (top) cp_async4(&fy(0, b), I.f[2] + g0);
      if (bottom) cp_async4(&fy(1, b), I.f[3] + g0 + (nv - 1) * P);
      cp_async_wait_all();
      // every cell adds, + 0 where nothing came (the sub-steps left no
      // -0), so that no register is updated under a condition
      #pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool from_side = (left || right) && r < rows_in;
        const bool from_top = top && r == 0;
        const bool from_bottom = bottom && r == nv - 1;
        const float fs = from_side ? side[r] : 0.0f;
        const float ft = from_top ? fy(0, b) : 0.0f;
        const float fb = from_bottom ? fy(1, b) : 0.0f;
        c[1][r] = c[1][r] + (left ? fs : 0.0f);
        c[0][r] = c[0][r] + (left ? 0.0f : fs);
        e[r] = e[r] + fs;
        c[3][r] = c[3][r] + ft;
        e[r] = e[r] + ft;
        c[2][r] = c[2][r] + fb;
        e[r] = e[r] + fb;
        // a cell that took no flow keeps the relabel computed before
        const bool got = fs != 0.0f || ft != 0.0f || fb != 0.0f;
        const float hp = h[r], ep = e[r], c0 = c[0][r], c1 = c[1][r],
                    c2 = c[2][r], c3 = c[3][r], hdn = SPT_DOWN(r),
                    hup = SPT_UP(r);
        float v = hn[r];
        if (__any_sync(FULL, got)) {
          const float w = lift_row(hp, ep, c0, c1, c2, c3, hdn, hup, r);
          if (got) v = w;
        }
        hn[r] = v;
      }
    }
    #pragma unroll
    for (int r = 0; r < R; ++r) h[r] = hn[r];
    if (p + 1 == phases) break;

    // the heights: the tile's edge to device memory, the strips' borders
    // to shared memory (the next parity)
    if (nv > 0) {
      const bool edge_col = col == 0 || col == TW - 1;
      float* hl_out = hx(pp ^ 1, 1, gi - 1);   // right of group gi - 1
      float* hr_out = hx(pp ^ 1, 0, gi + 1);   // left of group gi + 1
      float h_last = 0.0f;
      #pragma unroll
      for (int r = 0; r < R; ++r) {
        const float hv = h[r];
        if (r < rows_in && xin &&
            (edge_col || (b == 0 && r == 0) || (last_band && r == nv - 1)))
          __stcg(S.h + g0 + r * P, hv);
        if (r < nv && lane == 0 && gi > 0) hl_out[r] = hv;
        if (r < nv && lane == 31 && gi + 1 < nwb) hr_out[r] = hv;
        h_last = r == nv - 1 ? hv : h_last;
      }
      if (b > 0) hy(1, b - 1) = h[0];
      if (!last_band) hy(0, b + 1) = h_last;
    }
    __syncthreads();
    release(2 * p + 2);
    wait_for(2 * p + 2);
    // the neighbours' edge heights around the tile (INF outside the grid),
    // all in flight at once, into slots that only their reader reads
    if (nv > 0) {
      const bool left = lane == 0 && gi == 0;
      const bool right = lane == 31 && gi == nwb - 1;
      if (left || right) {
        float* dst = left ? hx(pp ^ 1, 0, 0) : hx(pp ^ 1, 1, nwb - 1);
        const bool in = left ? x > 0 : x + 1 < S.W;
        const float* src = S.h + g0 + (left ? -1 : 1);
        #pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < nv && in && r < rows_in) cp_async4(dst + r, src + r * P);
          else if (r < nv) dst[r] = INF_F;
        }
      }
      if (b == 0) {
        if (T.y0 > 0 && xin) cp_async4(&hy(0, 0), S.h + g0 - P);
        else hy(0, 0) = INF_F;
      }
      if (last_band) {
        if (T.y0 + TH < S.H && xin) cp_async4(&hy(1, b), S.h + g0 + nv * P);
        else hy(1, b) = INF_F;
      }
      cp_async_wait_all();
    }
  }

#undef SPT_LIFT
#undef SPT_UP
#undef SPT_DOWN
  __syncthreads();   // the scratch is read: the state back to its planes
  #pragma unroll
  for (int r = 0; r < R; ++r) {   // read before the condition (see above)
    const float v[5] = {c[0][r], c[1][r], c[2][r], c[3][r], e[r]};
    if (r < nv) {
      #pragma unroll
      for (int k = 0; k < 4; ++k) T.c[k][at(r)] = v[k];
      T.e[at(r)] = v[4];
    }
  }
  if (watch >= 0) {
    atomicAdd(S.flags + F_PUSH_CHECKS, checks);
    atomicAdd(S.flags + F_PUSH_WAITS, waits);
  }
  if (t == 0 && threadIdx.x == 0) atomicAdd(S.flags + F_PUSH_PHASES, phases);
  __syncthreads();
}

// One outer round of a resident solve: the tile loaded, `phases` push
// phases (push_block), then one BFS (bfs_events) and the tile stored.
template <int R>
__device__ __forceinline__ void resident_round(float* smem, State S,
                                               ResGeom G, Inflow I, int* ev,
                                               int* pw, int phases,
                                               int n_pass) {
  cg::grid_group grid = cg::this_grid();
  PushTile T = push_carve(smem, G.TH, G.TW);
  T.y0 = (blockIdx.x / G.ntx) * G.TH;
  T.x0 = (blockIdx.x % G.ntx) * G.TW;
  const int NWB = G.TW / 32;
  BfsTile B = bfs_carve(reinterpret_cast<uint32_t*>(smem + 7 * T.N), G.TH,
                        NWB);
  int* scratch = reinterpret_cast<int*>(smem + 7 * T.N) +
                 bfs_smem_words(G.TH, NWB);
  if (threadIdx.x == 0 && blockIdx.x == 0) S.flags[F_WORK] = 0;
  unsigned long long t_ns = global_ns();
  load_tile(T, S);
  if (phases > 0) push_block<R>(smem, T, S, G, I, pw, phases);

  // the grid's push block ends when its last tile's does
  unsigned long long* push_end =
      reinterpret_cast<unsigned long long*>(pw + (long)gridDim.x * WORD_STRIDE);
  if (threadIdx.x == 0) atomicMax(push_end, global_ns());

  // BFS: seed, the tile's bits, its published edges, then the tile runs.
  // The runs keep the distances as ints in the fl plane, which is free
  // until the next launch loads the tile: a look at a distance is then one
  // shared load, with no conversion from a float height.
  int* dist = reinterpret_cast<int*>(T.fl);
  for (int j = threadIdx.x; j < T.TH * T.TW; j += blockDim.x) {
    int i = (1 + j / T.TW) * T.SP + CX + j % T.TW;
    T.h[i] = T.e[i] < 0.0f ? 0.0f : INF_F;
    dist[i] = T.e[i] < 0.0f ? 0 : INF_I;
  }
  {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int w = warp; w < G.TH * NWB; w += nwarps) {
      int i = (1 + w / NWB) * T.SP + CX + 32 * (w % NWB) + lane;
      #pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t b = __ballot_sync(FULL, T.c[k][i] > 0.0f);
        if (lane == 0) B.op[k][w] = b;
      }
      uint32_t sb = __ballot_sync(FULL, T.e[i] < 0.0f);
      if (lane == 0) B.sink[w] = sb;
    }
  }
  bfs_forget_halo(B);
  if (threadIdx.x == 0) {
    ev[1 + blockIdx.x] = 0;
    if (blockIdx.x == 0) ev[0] = gridDim.x;
  }
  __syncthreads();
  publish_edges(T, S);
  grid.sync();
  // every tile is past its push block: its phase word back to 0 for the
  // next launch
  if (threadIdx.x == 0) pw[(long)blockIdx.x * WORD_STRIDE] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {   // its time to F_PUSH_NS
    const unsigned long long end = __ldcg(push_end);
    *reinterpret_cast<unsigned long long*>(S.flags + F_PUSH_NS) += end - t_ns;
    t_ns = end;
    *push_end = 0;
  }
  auto at = [&](int r, int x) { return (1 + r) * T.SP + CX + x; };
  int levels = 0;
  const int runs = bfs_events(ev, G, n_pass, scratch, [&](bool first) {
    bfs_load_halo(B, S, T.y0, T.x0);
    bool drop = bfs_tile(
        B, first, [&](int ry, int x) { return dist[at(ry, x)]; },
        [&](int ry, int x, int v) { dist[at(ry, x)] = v; }, &levels);
    return drop ? publish_edge_drops(T, S, dist, scratch + 1) : 0;
  });
  grid.sync();
  add_ns(S.flags, F_BFS_NS, &t_ns);
  if ((threadIdx.x & 31) == 0) atomicAdd(S.flags + F_LEVELS, levels);
  if (threadIdx.x == 0) atomicAdd(S.flags + F_TILE_RUNS, runs);

  // work test, then the state back to device memory
  bool act = false;
  for (int j = threadIdx.x; j < T.TH * T.TW; j += blockDim.x) {
    int ly = 1 + j / T.TW, lx = CX + j % T.TW;
    int i = ly * T.SP + lx;
    long g;
    if (!in_grid(T, S, i, &g)) continue;
    const float h = dist[i] < INF_I ? (float)dist[i] : INF_F;
    act |= T.e[i] > 0.0f && h < INF_F;
    #pragma unroll
    for (int k = 0; k < 4; ++k) __stcg(S.c[k] + g, T.c[k][i]);
    __stcg(S.e + g, T.e[i]);
    __stcg(S.h + g, h);
  }
  if (__syncthreads_or(act) && threadIdx.x == 0)
    atomicOr(S.flags + F_WORK, 1);
}

// The resident kernel for strips of up to R cells; the namespace keeps the
// kernel's own name in a trace.
#define SPT_RESIDENT_KERNEL(R)                                              \
  namespace strip##R {                                                      \
  __global__ void __launch_bounds__(THREADS)                                \
      resident_round_kernel(State S, ResGeom G, Inflow I, int* ev, int* pw, \
                            int phases, int n_pass) {                       \
    extern __shared__ __align__(16) float smem[];                           \
    resident_round<R>(smem, S, G, I, ev, pw, phases, n_pass);               \
  }                                                                         \
  }
SPT_RESIDENT_KERNEL(7)
SPT_RESIDENT_KERNEL(8)
SPT_RESIDENT_KERNEL(12)
SPT_RESIDENT_KERNEL(16)
#undef SPT_RESIDENT_KERNEL

using ResidentKernel = void (*)(State, ResGeom, Inflow, int*, int*, int, int);

// The kernel whose strips hold a band of G.RB rows (nullptr: none does).
ResidentKernel resident_kernel(const ResGeom& G) {
  if (G.RB < 1) return nullptr;
  if (G.RB <= 7) return strip7::resident_round_kernel;
  if (G.RB <= 8) return strip8::resident_round_kernel;
  if (G.RB <= 12) return strip12::resident_round_kernel;
  if (G.RB <= 16) return strip16::resident_round_kernel;
  return nullptr;
}

// The squarest tiling (least TH + TW) of the grid into at most `ctas`
// tiles whose shared memory fits `smem_max`; false if there is none.
bool resident_geom(int H, int W, int ctas, int smem_max, ResGeom* G,
                   size_t* smem) {
  bool found = false;
  for (int nwb = 1; 32 * (nwb - 1) < W; ++nwb) {
    int TW = 32 * nwb, ntx = (W + TW - 1) / TW;
    if (ntx > ctas) continue;
    int TH = (H + ctas / ntx - 1) / (ctas / ntx);
    int nty = (H + TH - 1) / TH;
    size_t bytes = push_smem_bytes(TH, TW) +
                   (size_t)bfs_smem_words(TH, nwb) * sizeof(uint32_t) +
                   RES_SCRATCH_INTS * sizeof(int);
    if (bytes > (size_t)smem_max) continue;
    if (!found || TH + TW < G->TH + G->TW) {
      *G = ResGeom{TH, TW, nty, ntx};
      *smem = bytes;
      found = true;
    }
  }
  if (found) {   // the push block's bands: 16 / nwb of them, RB rows each
    const int nwb = G->TW / 32;
    const int bands = nwb <= THREADS / 32 ? THREADS / 32 / nwb : 0;
    G->RB = bands ? (G->TH + bands - 1) / bands : 0;
  }
  return found;
}

}  // namespace

extern "C" {

// Floats of device scratch spt_grid_mincut needs for an (H, W) grid: the
// state, the inflow planes, the tiled solver's flags, the words of the
// resident BFS's events and the resident tiles' phase words.
long long spt_work_floats(int H, int W) {
  return state_floats(H, W) + 4L * H * pitch_of(W) +
         tiled_extra_floats(H, W) + EVENT_WORDS + PHASE_WORDS;
}

// Solve one grid; arguments, outputs and return code as
// spt_grid_mincut_tiled in csrc/mincut_tiled.cu. stats (host) gets {outer
// rounds, BFS rounds (0 if the tiles were resident: no rounds), launches,
// host reads, push tiles worked, 1 if the tiles were resident, ns in push
// blocks, ns in BFSs, BFS levels, and, resident only, BFS tile runs, push
// phases, neighbour phase-word checks and the checks that waited}.
int spt_grid_mincut(const float* cap_h, const float* cap_v, const float* exc,
                    const uint8_t* node, uint8_t* side, float* dist,
                    float* work, int* flags, int H, int W, int max_outer,
                    int inner_iters, int sweep_iters, void* stream,
                    long long* stats) {
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  ResGeom G;
  size_t smem = 0;
  int ctas = 0;
  bool resident = resident_geom(H, W, sms, max_smem_optin(), &G, &smem);
  ResidentKernel kernel = resident ? resident_kernel(G) : nullptr;
  resident = kernel && push_scratch_floats(G.TH, G.TW, G.RB) <=
                           5L * (G.TH + 2) * (G.TW + 8);
  if (resident) {
    if ((err = coop_capacity(kernel, smem, &ctas)) != cudaSuccess)
      return (int)err;
    resident = ctas >= G.nty * G.ntx && G.nty * G.ntx <= RES_MAX_TILES;
  }
  if (stats) stats[5] = resident ? 1 : 0;
  if (!resident)
    return (int)tiled_solve(cap_h, cap_v, exc, node, side, dist, work, flags,
                            H, W, max_outer, inner_iters, sweep_iters, s,
                            stats);

  State S = carve_state(work, node, flags, H, W);
  Inflow I;
  long n = (long)H * S.P;
  for (int k = 0; k < 4; ++k) I.f[k] = work + state_floats(H, W) + k * n;
  const long ev_at = state_floats(H, W) + 4 * n + tiled_extra_floats(H, W);
  int* ev = reinterpret_cast<int*>(work + ev_at);
  const long pw_at =
      (ev_at + EVENT_WORDS + WORD_STRIDE - 1) / WORD_STRIDE * WORD_STRIDE;
  int* pw = reinterpret_cast<int*>(work + pw_at);
  const int tiles = G.nty * G.ntx;
  if ((err = cudaMemsetAsync(pw, 0,
                             (size_t)(tiles + 1) * WORD_STRIDE * sizeof(int),
                             s)) != cudaSuccess)
    return (int)err;
  HostLoop L;
  L.s = s;
  L.flags = flags;
  auto round = [&](bool first) -> cudaError_t {
    int phases = first ? 0 : inner_iters;
    void* args[] = {&S, &G, &I, &ev, &pw, &phases, &sweep_iters};
    cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)kernel, dim3(tiles), dim3(THREADS), args, smem, s);
    if (e != cudaSuccess) return e;
    return L.check();
  };
  err = solve_loop(S, L, cap_h, cap_v, exc, side, dist, max_outer, round,
                   stats);
  if (err == cudaSuccess && stats) {
    stats[9] = L.last[F_TILE_RUNS];
    stats[10] = L.last[F_PUSH_PHASES];
    stats[11] = L.last[F_PUSH_CHECKS];
    stats[12] = L.last[F_PUSH_WAITS];
  }
  return (int)err;
}

const char* spt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
