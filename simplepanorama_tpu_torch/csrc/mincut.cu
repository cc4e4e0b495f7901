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
//   four sub-steps inside a tile as there, flows that leave a tile land in
//   its halo and go out through device memory (an inflow plane per
//   direction); after a grid barrier every tile adds what its edge cells
//   received, then relabels, publishes its edge heights and, after a
//   second grid barrier, reads its halo heights. A flow that crosses a
//   tile edge is thus applied after the phase's four sub-steps rather than
//   inside them: the receiving cell pushes less in that phase, which is
//   still a valid push-relabel schedule, and every flow is applied before
//   any cell relabels, so no label goes invalid.
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
//   cells on an H100) takes the tiled solver of csrc/mincut_tiled.cu
//   instead (last_stats["resident"] says which ran).
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
};

struct Inflow {
  float* f[4];   // flow that moved in direction k into a tile's edge cell
};

// halo edge cell j of 2 * TW + 2 * TH: its smem index and the direction of
// a flow from the tile into it (top: up, bottom: down, left, right)
__device__ __forceinline__ int halo_cell(const PushTile& T, int j, int* k) {
  if (j < T.TW) { *k = 3; return CX + j; }
  j -= T.TW;
  if (j < T.TW) { *k = 2; return (T.TH + 1) * T.SP + CX + j; }
  j -= T.TW;
  if (j < T.TH) { *k = 1; return (1 + j) * T.SP + CX - 1; }
  j -= T.TH;
  *k = 0;
  return (1 + j) * T.SP + CX + T.TW;
}

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

// read the halo heights the neighbours published; ends with a barrier
__device__ __forceinline__ void read_halo_heights(const PushTile& T, const State& S) {
  for (int j = threadIdx.x; j < 2 * (T.TW + T.TH); j += blockDim.x) {
    int k;
    int i = halo_cell(T, j, &k);
    long g;
    if (in_grid(T, S, i, &g)) T.h[i] = __ldcg(S.h + g);
  }
  __syncthreads();
}

// Kernel 1's own flag slot, one the shared flags leave free: BFS tile
// runs, summed over CTAs and BFSs.
constexpr int F_TILE_RUNS = 7;
static_assert(F_LEVELS < F_TILE_RUNS && F_TILE_RUNS < F_PUSH_NS,
              "F_TILE_RUNS lies between the shared flags");

// The most tiles the resident route takes (one per SM), and the device
// words of its event-driven BFS, after the rest of the work buffer: the
// runs owed, then the runs asked of each tile.
constexpr int RES_MAX_TILES = 1023;
constexpr long EVENT_WORDS = RES_MAX_TILES + 1;

// ints of shared scratch the resident kernel takes past its BFS tile
constexpr int RES_SCRATCH_INTS = 2;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
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

__global__ void __launch_bounds__(THREADS)
resident_round_kernel(State S, ResGeom G, Inflow I, int* ev, int phases,
                      int n_pass) {
  extern __shared__ __align__(16) float smem[];
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
  const int rev[4] = {1, 0, 3, 2};
  const int n_halo = 2 * (T.TW + T.TH);

  for (int ph = 0; ph < phases; ++ph) {
    for (int j = threadIdx.x; j < n_halo; j += blockDim.x) {
      int k;
      T.e[halo_cell(T, j, &k)] = 0.0f;   // collects what the tile sends
    }
    __syncthreads();
    Box box = full_box(T);
    push_substeps(T, box);
    for (int j = threadIdx.x; j < n_halo; j += blockDim.x) {
      int k;
      int i = halo_cell(T, j, &k);
      long g;
      float* out = k == 0 ? I.f[0] : k == 1 ? I.f[1] : k == 2 ? I.f[2] : I.f[3];
      if (in_grid(T, S, i, &g)) __stcg(out + g, T.e[i]);
    }
    grid.sync();
    // what the edge cells received from the neighbour tiles; a corner cell
    // has two sides, so one thread takes all of a cell's sides
    for (int j = threadIdx.x; j < n_edge(T); j += blockDim.x) {
      int ly, lx;
      edge_cell(T, j, &ly, &lx);
      int y = T.y0 + ly - 1, x = T.x0 + lx - CX;
      if (y >= S.H || x >= S.W) continue;
      int i = ly * T.SP + lx;
      long g = (long)y * S.P + x;
      // flow that moved right into the left edge, left into the right
      // edge, down into the top edge, up into the bottom edge, where a
      // neighbour tile sent it
      const bool from[4] = {lx == CX && x > 0,
                            lx == CX + T.TW - 1 && x + 1 < S.W,
                            ly == 1 && y > 0,
                            ly == T.TH && y + 1 < S.H};
      #pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!from[k]) continue;
        float f = __ldcg(I.f[k] + g);
        T.c[rev[k]][i] = T.c[rev[k]][i] + f;
        T.e[i] = T.e[i] + f;
      }
    }
    __syncthreads();
    relabel(T, full_box(T));
    publish_edges(T, S);
    grid.sync();
    read_halo_heights(T, S);
  }

  // BFS: seed, the tile's bits, its published edges, then the tile runs.
  // The runs keep the distances as ints in the fl plane, which is free
  // until the next launch loads the tile: a look at a distance is then one
  // shared load, with no conversion from a float height.
  add_ns(S.flags, F_PUSH_NS, &t_ns);
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
  return found;
}

}  // namespace

extern "C" {

// Floats of device scratch spt_grid_mincut needs for an (H, W) grid: the
// state, the inflow planes, the tiled solver's flags and the words of the
// resident BFS's events.
long long spt_work_floats(int H, int W) {
  return state_floats(H, W) + 4L * H * pitch_of(W) +
         tiled_extra_floats(H, W) + EVENT_WORDS;
}

// Solve one grid; arguments, outputs and return code as
// spt_grid_mincut_tiled in csrc/mincut_tiled.cu. stats (host) gets {outer
// rounds, BFS rounds (0 if the tiles were resident: no rounds), launches,
// host reads, push tiles worked, 1 if the tiles were resident, ns in push
// blocks, ns in BFSs, BFS levels, BFS tile runs (resident only)}.
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
  if (resident) {
    if ((err = coop_capacity(resident_round_kernel, smem, &ctas)) !=
        cudaSuccess)
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
  int* ev = reinterpret_cast<int*>(work + state_floats(H, W) + 4 * n +
                                   tiled_extra_floats(H, W));
  HostLoop L;
  L.s = s;
  L.flags = flags;
  auto round = [&](bool first) -> cudaError_t {
    int phases = first ? 0 : inner_iters;
    void* args[] = {&S, &G, &I, &ev, &phases, &sweep_iters};
    cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)resident_round_kernel, dim3(G.nty * G.ntx),
        dim3(THREADS), args, smem, s);
    if (e != cudaSuccess) return e;
    return L.check();
  };
  err = solve_loop(S, L, cap_h, cap_v, exc, side, dist, max_outer, round,
                   stats);
  if (err == cudaSuccess && stats) stats[9] = L.last[F_TILE_RUNS];
  return (int)err;
}

const char* spt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
