// Pieces both min-cut kernels (csrc/mincut.cu, csrc/mincut_tiled.cu) share:
// the state planes in device memory, the push/relabel phase of one tile in
// shared memory, the loads and stores of a tile, the BFS passes over the
// state, and the host side of a cooperative launch.
//
// State. Every plane is (H, P) row-major with the pitch P = W rounded up
// to 32, so that each row starts 128-byte aligned and a tile's rows load
// with 16-byte cp.async copies: residual capacities c[4] toward the right,
// left, lower and upper neighbour, excess e, and heights h (distances in a
// BFS), as float; padding columns hold c = 0, e = 0, h = INF. The BFS
// keeps its open-direction and sink bits packed 32 cells to a word.
//
// Memory model. Tiles are read by other CTAs than the ones that wrote them
// within one persistent launch, so every load of the state bypasses L1
// (cp.async.cg, __ldcg) and the grid barriers order the writes (in kernel
// 1's resident route, release and acquire of the tiles' own words do).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mincut_bfs.cuh"

namespace cg = cooperative_groups;

namespace spt {

constexpr int THREADS = 512;
constexpr int CX = 4;   // column of a tile's first interior cell in smem

struct State {
  float* c[4];
  float* e;
  float* h;
  uint32_t* bits[5];    // open right/left/down/up, sink: (H, P / 32) words
  const uint8_t* node;  // (H, W)
  int* flags;           // see Flag
  int H, W, P, NWg;     // NWg = P / 32
};

// device flags, shared with the host wrapper
enum Flag {
  F_ROUND = 0,      // [0..2] "a BFS round changed something", by round % 3
  F_WORK = 3,       // positive excess can still reach a sink
  F_BFS_ROUNDS = 4, // BFS rounds run (all BFSs)
  F_TILES = 5,      // push tiles worked (all phases)
  F_LEVELS = 6,     // BFS levels run, summed over tiles and rounds
  F_PUSH_NS = 8,    // [8..9] ns in push blocks (one u64, all launches)
  F_BFS_NS = 10,    // [10..11] ns in BFSs, seed included (one u64)
  F_COUNT = 16      // 7 and 12..15: kernel 1's own (csrc/mincut.cu)
};

// the device's nanosecond clock, read by one thread at grid barriers to
// split a launch's time between its push block and its BFS
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// block 0, thread 0: add the time since *t to the u64 counter at flag f
__device__ __forceinline__ void add_ns(int* flags, int f, unsigned long long* t) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  unsigned long long now = global_ns();
  *reinterpret_cast<unsigned long long*>(flags + f) += now - *t;
  *t = now;
}

__host__ __device__ __forceinline__ int pitch_of(int W) { return (W + 31) / 32 * 32; }

__host__ __device__ __forceinline__ long state_floats(int H, int W) {
  long n = (long)H * pitch_of(W);
  return 6 * n + 5 * (n / 32);
}

inline State carve_state(float* work, const uint8_t* node, int* flags,
                         int H, int W) {
  State S;
  S.H = H;
  S.W = W;
  S.P = pitch_of(W);
  S.NWg = S.P / 32;
  long n = (long)H * S.P;
  for (int k = 0; k < 4; ++k) S.c[k] = work + k * n;
  S.e = work + 4 * n;
  S.h = work + 5 * n;
  uint32_t* b = reinterpret_cast<uint32_t*>(work + 6 * n);
  for (int k = 0; k < 5; ++k) S.bits[k] = b + k * (n / 32);
  S.node = node;
  S.flags = flags;
  return S;
}

// residual capacities and clipped excess of the seam graph, padding included
__global__ void init_kernel(const float* __restrict__ cap_h,
                            const float* __restrict__ cap_v,
                            const float* __restrict__ exc, State S) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int H = S.H, W = S.W;
  if (x >= S.P || y >= H) return;
  long q = (long)y * S.P + x;
  if (x >= W) {
    #pragma unroll
    for (int k = 0; k < 4; ++k) S.c[k][q] = 0.0f;
    S.e[q] = 0.0f;
    S.h[q] = INF_F;
    return;
  }
  long p = (long)y * W + x;
  const uint8_t* node = S.node;
  float nf = node[p] ? 1.0f : 0.0f;
  // left/up edges live at the neighbour's index in cap_h/cap_v
  float r = (x + 1 < W) ? cap_h[p] * nf * (node[p + 1] ? 1.0f : 0.0f) : 0.0f;
  float l = (x > 0) ? cap_h[p - 1] * (node[p - 1] ? 1.0f : 0.0f) * nf : 0.0f;
  float d = (y + 1 < H) ? cap_v[p] * nf * (node[p + W] ? 1.0f : 0.0f) : 0.0f;
  float u = (y > 0) ? cap_v[p - W] * (node[p - W] ? 1.0f : 0.0f) * nf : 0.0f;
  S.c[0][q] = r;
  S.c[1][q] = l;
  S.c[2][q] = d;
  S.c[3][q] = u;
  float ev = node[p] ? exc[p] : 0.0f;
  float cs = r + l + d + u + 1.0f;
  S.e[q] = fminf(fmaxf(ev, -cs), cs);
  S.h[q] = INF_F;
}

// source side (node cells that cannot reach a sink) and, when asked, the
// distances of the last BFS, unpitched
__global__ void side_kernel(State S, uint8_t* __restrict__ side,
                            float* __restrict__ dist) {
  long n = (long)S.H * S.W;
  long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  long q = (p / S.W) * S.P + p % S.W;
  float h = S.h[q];
  side[p] = (h >= INF_F && S.node[p]) ? 1 : 0;
  if (dist) dist[p] = h;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// One push tile in shared memory: TH x TW interior cells (TW a multiple of
// 32) and a 1-cell halo, rows of pitch SP = TW + 8 floats with the
// interior at columns CX .. CX + TW - 1 (16-byte aligned). Planes c[4], e,
// h and the scratch fl.
struct PushTile {
  float* c[4];
  float* e;
  float* h;
  float* fl;          // flows of a sub-step; 0 outside the phase's box
  int* red;           // [4] block reduction of active_box
  int TH, TW, SP, N;   // N = (TH + 2) * SP
  int y0, x0;          // grid position of the first interior cell
};

// the tile's planes and 4 ints for active_box
__host__ __device__ __forceinline__ size_t push_smem_bytes(int TH, int TW) {
  return (size_t)7 * (TH + 2) * (TW + 8) * sizeof(float) + 4 * sizeof(int);
}

__device__ __forceinline__ PushTile push_carve(float* base, int TH, int TW) {
  PushTile T;
  T.TH = TH;
  T.TW = TW;
  T.SP = TW + 8;
  T.N = (TH + 2) * T.SP;
  #pragma unroll
  for (int k = 0; k < 4; ++k) T.c[k] = base + k * T.N;
  T.e = base + 4 * T.N;
  T.h = base + 5 * T.N;
  T.fl = base + 6 * T.N;
  T.red = reinterpret_cast<int*>(base + 7 * T.N);
  T.y0 = T.x0 = 0;
  return T;
}

__device__ __forceinline__ bool interior_at(const PushTile& T, int ly, int lx) {
  return ly >= 1 && ly <= T.TH && lx >= CX && lx < CX + T.TW;
}

// an edge-halo cell (not a corner, not an unused column)
__device__ __forceinline__ bool edge_halo_at(const PushTile& T, int ly,
                                             int lx) {
  bool col_in = lx >= CX && lx < CX + T.TW;
  bool row_in = ly >= 1 && ly <= T.TH;
  return (row_in && (lx == CX - 1 || lx == CX + T.TW)) ||
         (col_in && (ly == 0 || ly == T.TH + 1));
}

// Load the tile at (y0, x0) with its edge halo: interior-column chunks of
// every row by 16-byte cp.async, the two halo columns by __ldcg, and the
// rest (corners, unused columns, cells outside the grid) as c = 0, e = 0,
// h = INF. Ends with a barrier.
__device__ __forceinline__ void load_tile(const PushTile& T, const State& S) {
  const int nq = T.TW / 4, rows = T.TH + 2;
  for (int j = threadIdx.x; j < rows * nq; j += blockDim.x) {
    int ly = j / nq, q = j % nq;
    int y = T.y0 + ly - 1, x = T.x0 + 4 * q;
    int i = ly * T.SP + CX + 4 * q;
    if (y >= 0 && y < S.H && x < S.P) {
      long g = (long)y * S.P + x;
      #pragma unroll
      for (int k = 0; k < 4; ++k) cp_async16(T.c[k] + i, S.c[k] + g);
      cp_async16(T.e + i, S.e + g);
      cp_async16(T.h + i, S.h + g);
    } else {
      for (int u = 0; u < 4; ++u) {
        #pragma unroll
        for (int k = 0; k < 4; ++k) T.c[k][i + u] = 0.0f;
        T.e[i + u] = 0.0f;
        T.h[i + u] = INF_F;
      }
    }
  }
  // columns outside the interior ones: the two halo columns, else empty
  const int side_cols = T.SP - T.TW;
  for (int j = threadIdx.x; j < rows * side_cols; j += blockDim.x) {
    int ly = j / side_cols, s = j % side_cols;
    int lx = s < CX ? s : CX + T.TW + (s - CX);
    int i = ly * T.SP + lx;
    int y = T.y0 + ly - 1, x = T.x0 + lx - CX;
    bool halo = ly >= 1 && ly <= T.TH && (lx == CX - 1 || lx == CX + T.TW);
    if (halo && y < S.H && x >= 0 && x < S.W) {
      long g = (long)y * S.P + x;
      #pragma unroll
      for (int k = 0; k < 4; ++k) T.c[k][i] = __ldcg(S.c[k] + g);
      T.e[i] = __ldcg(S.e + g);
      T.h[i] = __ldcg(S.h + g);
    } else {
      #pragma unroll
      for (int k = 0; k < 4; ++k) T.c[k][i] = 0.0f;
      T.e[i] = 0.0f;
      T.h[i] = INF_F;
    }
  }
  for (int i = threadIdx.x; i < T.N; i += blockDim.x) T.fl[i] = 0.0f;
  cp_async_wait_all();
  __syncthreads();
}

// A box of smem rows r0..r1 and columns c0..c1 (inclusive) of a push
// tile: where a phase works. Loops over it are flat, a thread per cell.
struct Box {
  int r0, r1, c0, c1;
};

// the whole tile with its edge halo
__device__ __forceinline__ Box full_box(const PushTile& T) {
  return Box{0, T.TH + 1, CX - 1, CX + T.TW};
}

// f(ly, lx) for every cell of the box; the row of flat index k comes
// from a multiply-high by (2^32 - 1) / width and one correction (exact
// for k < 2^20)
template <class F>
__device__ __forceinline__ void for_box(const Box& b, F f) {
  const unsigned nc = b.c1 - b.c0 + 1, n = (b.r1 - b.r0 + 1) * nc;
  const unsigned magic = 0xffffffffu / nc;
  for (unsigned k = threadIdx.x; k < n; k += blockDim.x) {
    unsigned q = __umulhi(k, magic);
    if ((q + 1) * nc <= k) ++q;
    f(b.r0 + (int)q, b.c0 + (int)(k - q * nc));
  }
}

// The 4 push sub-steps of one phase, each lock-step over the tile: every
// flow of a sub-step is computed from the state before it (into fl), then
// applied. Only interior cells push; halo cells only receive. A cell at
// height INF does not push: the last BFS found no path from it to a sink,
// no cell below INF pushes into it and it cannot lift (every neighbour it
// has capacity toward is at INF too), so its excess stays where it is
// until the next BFS whatever it does. The plain versions let such cells
// push among themselves (INF == INF + 1 in float); that flow changes no
// cell's distance to a sink.
//
// Only cells inside `box` push; it must hold every cell that may (positive
// excess below INF), and fl must be 0 outside it (load_tile clears it,
// relabel leaves it so, and the box only grows). A sub-step moves flow
// one cell in its direction, so the box grows by one cell that way after
// it (clipped to the tile and its halo) and then holds every cell that
// may push in the next sub-step.
__device__ __forceinline__ void push_substeps(const PushTile& T, Box& box) {
  const int rev[4] = {1, 0, 3, 2};
  #pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = dir_dy(k), dx = dir_dx(k), off = dy * T.SP + dx;
    float* ck = T.c[k];
    float* cr = T.c[rev[k]];
    for_box(box, [&](int ly, int lx) {
      const int i = ly * T.SP + lx;
      float f = 0.0f;
      if (interior_at(T, ly, lx)) {
        float ep = T.e[i], cp = ck[i];
        float hp = T.h[i];
        if (ep > 0.0f && hp < INF_F && hp == T.h[i + off] + 1.0f &&
            cp > 0.0f)
          f = fminf(ep, cp);
      }
      T.fl[i] = f;
    });
    __syncthreads();
    Box grown = box;
    if (dx > 0) grown.c1 = min(grown.c1 + 1, CX + T.TW);
    if (dx < 0) grown.c0 = max(grown.c0 - 1, CX - 1);
    if (dy > 0) grown.r1 = min(grown.r1 + 1, T.TH + 1);
    if (dy < 0) grown.r0 = max(grown.r0 - 1, 0);
    for_box(grown, [&](int ly, int lx) {
      const int i = ly * T.SP + lx;
      const int qy = ly - dy, qx = lx - dx;
      float f = T.fl[i];
      float b = (qy >= 0 && qy <= T.TH + 1 && qx >= 0 && qx < T.SP)
                    ? T.fl[i - off] : 0.0f;
      ck[i] = ck[i] - f;
      cr[i] = cr[i] + b;
      T.e[i] = T.e[i] - f + b;
    });
    __syncthreads();
    box = grown;   // the next flow loop writes fl over all of it
  }
}

// The relabel of one phase over `box` (every cell with positive excess is
// in it): an active interior cell with no admissible edge lifts to 1 +
// the lowest neighbour height it has residual capacity toward. Halo
// heights stay. Two barriers; leaves fl at 0. Returns, block-uniform,
// whether an interior cell may still push (positive excess below INF).
__device__ __forceinline__ bool relabel(const PushTile& T, const Box& box) {
  for_box(box, [&](int ly, int lx) {
    const int i = ly * T.SP + lx;
    float hp = T.h[i], hn = hp;
    if (interior_at(T, ly, lx) && T.e[i] > 0.0f) {
      float min_h = INF_F;
      bool adm = false;
      #pragma unroll
      for (int k = 0; k < 4; ++k) {
        float nb = T.h[i + dir_dy(k) * T.SP + dir_dx(k)];
        bool has_cap = T.c[k][i] > 0.0f;
        min_h = fminf(min_h, has_cap ? nb : INF_F);
        adm = adm || (has_cap && hp == nb + 1.0f);
      }
      if (!adm && min_h < INF_F) hn = min_h + 1.0f;
    }
    T.fl[i] = hn;
  });
  __syncthreads();
  bool busy = false;
  for_box(box, [&](int ly, int lx) {
    const int i = ly * T.SP + lx;
    if (interior_at(T, ly, lx)) {
      T.h[i] = T.fl[i];
      busy |= T.e[i] > 0.0f && T.fl[i] < INF_F;
    }
    T.fl[i] = 0.0f;
  });
  return __syncthreads_or(busy);
}

// Bounding box of the tile's interior cells that may push (positive
// excess below INF); r0 > r1 when there is none. Two barriers.
__device__ __forceinline__ Box active_box(const PushTile& T) {
  int* red = T.red;
  if (threadIdx.x == 0) {
    red[0] = red[2] = 1 << 30;
    red[1] = red[3] = -1;
  }
  __syncthreads();
  Box b{1 << 30, -1, 1 << 30, -1};
  for_box(Box{1, T.TH, CX, CX + T.TW - 1}, [&](int ly, int lx) {
    const int i = ly * T.SP + lx;
    if (T.e[i] > 0.0f && T.h[i] < INF_F) {
      b.r0 = min(b.r0, ly);
      b.r1 = max(b.r1, ly);
      b.c0 = min(b.c0, lx);
      b.c1 = max(b.c1, lx);
    }
  });
  if (b.r1 >= 0) {
    atomicMin(red + 0, b.r0);
    atomicMax(red + 1, b.r1);
    atomicMin(red + 2, b.c0);
    atomicMax(red + 3, b.c1);
  }
  __syncthreads();
  return Box{red[0], red[1], red[2], red[3]};
}

// Halo distances of the BFS tile at (y0, x0) of BH x 32*NWB cells from the
// global heights (INF_I outside the grid). Ends with a barrier.
__device__ __forceinline__ void bfs_load_halo(const BfsTile& B, const State& S, int y0,
                                     int x0) {
  const int BW = 32 * B.NWB, BH = B.BH;
  for (int i = threadIdx.x; i < 2 * BW + 2 * BH; i += blockDim.x) {
    int y, x;
    if (i < BW) { y = y0 - 1; x = x0 + i; }
    else if (i < 2 * BW) { y = y0 + BH; x = x0 + i - BW; }
    else if (i < 2 * BW + BH) { y = y0 + i - 2 * BW; x = x0 - 1; }
    else { y = y0 + i - 2 * BW - BH; x = x0 + BW; }
    int d = INF_I;
    if (y >= 0 && y < S.H && x >= 0 && x < S.W)
      d = height_to_int(__ldcg(S.h + (long)y * S.P + x));
    if (i < BW) B.halo[0][i] = d;
    else if (i < 2 * BW) B.halo[1][i - BW] = d;
    else if (i < 2 * BW + BH) B.halo[2][i - 2 * BW] = d;
    else B.halo[3][i - 2 * BW - BH] = d;
  }
  __syncthreads();
}

// BFS seed over the whole grid (grid-stride, one warp per 32-cell word):
// the packed open-direction and sink bits, and h = 0 at sinks, INF
// elsewhere.
__device__ __forceinline__ void bfs_seed_global(const State& S) {
  const int lane = threadIdx.x & 31;
  const long nwarps = (long)gridDim.x * blockDim.x / 32;
  const long total = (long)S.H * S.NWg;
  for (long wi = ((long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       wi < total; wi += nwarps) {
    int y = (int)(wi / S.NWg), x = (int)(wi % S.NWg) * 32 + lane;
    long q = (long)y * S.P + x;
    bool nd = x < S.W && S.node[(long)y * S.W + x];
    bool sink = nd && __ldcg(S.e + q) < 0.0f;
    #pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t b = __ballot_sync(FULL, nd && __ldcg(S.c[k] + q) > 0.0f);
      if (lane == 0) S.bits[k][wi] = b;
    }
    uint32_t sb = __ballot_sync(FULL, sink);
    if (lane == 0) S.bits[4][wi] = sb;
    __stcg(S.h + q, sink ? 0.0f : INF_F);
  }
}

// Rounds of tile BFSs until a round changes nothing (or n_pass rounds):
// one BFS over the grid, driven on the device. tile(t, r) works tile t in
// round r and returns whether a distance on its edge dropped. Every CTA of
// the grid calls it.
template <class TileFn>
__device__ __forceinline__ void bfs_rounds(cg::grid_group& grid, const State& S,
                                  int n_tiles, int n_pass, TileFn tile) {
  for (int r = 0; r < n_pass; ++r) {
    bool changed = false;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
      changed |= tile(t, r);
    if (threadIdx.x == 0) {
      if (changed) atomicOr(S.flags + F_ROUND + r % 3, 1);
      if (blockIdx.x == 0) {
        S.flags[F_ROUND + (r + 1) % 3] = 0;
        atomicAdd(S.flags + F_BFS_ROUNDS, 1);
      }
    }
    grid.sync();
    if (__ldcg(S.flags + F_ROUND + r % 3) == 0) break;
  }
}

// Host side: the number of CTAs of a cooperative launch of `kernel` with
// THREADS threads and `smem` bytes of dynamic shared memory that can all
// be resident at once (0 if none can).
template <class K>
inline cudaError_t coop_capacity(K kernel, size_t smem, int* ctas) {
  *ctas = 0;
  int dev = 0, sms = 0, coop = 0, occ = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, kernel, THREADS, smem)) != cudaSuccess)
    return err;
  *ctas = occ * sms;
  return cudaSuccess;
}

inline int max_smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

// What the host loop of both solvers keeps: its counters and the flag
// read after every launch (one host read per BFS).
struct HostLoop {
  cudaStream_t s;
  int* flags;
  long long launches = 0;
  long long host_reads = 0;
  int last[F_COUNT] = {};   // the flags after the last launch

  cudaError_t check() {
    ++launches;
    return cudaGetLastError();
  }

  long long ns(int f) const {
    unsigned long long v;
    memcpy(&v, last + f, sizeof(v));
    return (long long)v;
  }

  cudaError_t read() {
    ++host_reads;
    cudaError_t err = cudaMemcpyAsync(last, flags, sizeof(last),
                                      cudaMemcpyDeviceToHost, s);
    if (err != cudaSuccess) return err;
    return cudaStreamSynchronize(s);
  }
};

// Init, then `round(first)` launches (each one BFS, the first with no push
// block before it) until no positive excess can reach a sink or
// max_outer push blocks ran, then the side. stats: {outer rounds, BFS
// rounds, launches, host reads, push tiles worked, (left to the caller),
// ns in push blocks, ns in BFSs, BFS levels summed over tiles}.
template <class RoundFn>
inline cudaError_t solve_loop(const State& S, HostLoop& L,
                              const float* cap_h, const float* cap_v,
                              const float* exc, uint8_t* side, float* dist,
                              int max_outer, RoundFn round,
                              long long* stats) {
  cudaError_t err;
  if ((err = cudaMemsetAsync(S.flags, 0, F_COUNT * sizeof(int), L.s)) !=
      cudaSuccess)
    return err;
  dim3 blk2(32, 8), grd2((S.P + 31) / 32, (S.H + 7) / 8);
  init_kernel<<<grd2, blk2, 0, L.s>>>(cap_h, cap_v, exc, S);
  if ((err = L.check()) != cudaSuccess) return err;
  if ((err = round(true)) != cudaSuccess) return err;
  if ((err = L.read()) != cudaSuccess) return err;
  int it = 0;
  while (it < max_outer && L.last[F_WORK]) {
    if ((err = round(false)) != cudaSuccess) return err;
    if ((err = L.read()) != cudaSuccess) return err;
    ++it;
  }
  long n = (long)S.H * S.W;
  side_kernel<<<(unsigned)((n + 255) / 256), 256, 0, L.s>>>(S, side, dist);
  if ((err = L.check()) != cudaSuccess) return err;
  if (stats) {
    stats[0] = it;
    stats[1] = L.last[F_BFS_ROUNDS];
    stats[2] = L.launches;
    stats[3] = L.host_reads;
    stats[4] = L.last[F_TILES];
    stats[6] = L.ns(F_PUSH_NS);
    stats[7] = L.ns(F_BFS_NS);
    stats[8] = L.last[F_LEVELS];
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The tiled solver (kernel 2, and kernel 1 for grids whose state does not
// fit the co-resident CTAs): one cooperative launch per outer round.

struct TiledGeom {
  int TH, TW, nty, ntx;   // push tiles
  int BH, NWB, nby, nbx;  // BFS tiles
};

constexpr int TILED_TH = 16, TILED_TW = 128;
constexpr int TILED_BH = 128, TILED_NWB = 4;
// push/relabel phases a push tile runs per visit while it sits in shared
// memory (mincut_tiled.cu, "Local phases"); 3 to 10 time alike on the
// 1272x1280 seam block
constexpr int TILED_LOCAL_PHASES = 5;

// Store the tile's interior and edge-halo cells (heights of the interior
// only) and update the active-tile flags: the tile stays active while an
// interior cell holds excess below INF, and a neighbour tile becomes active
// when a halo cell on its side does. No other live CTA touches any of
// these cells or flags (the four colours).
__device__ __forceinline__ void store_tile(const PushTile& T, const State& S,
                                  int* tact, int ty, int tx, int nty,
                                  int ntx) {
  bool act = false, top = false, bot = false, lft = false, rgt = false;
  for (int i = threadIdx.x; i < T.N; i += blockDim.x) {
    int ly = i / T.SP, lx = i % T.SP;
    bool in = interior_at(T, ly, lx);
    if (!in && !edge_halo_at(T, ly, lx)) continue;
    int y = T.y0 + ly - 1, x = T.x0 + lx - CX;
    if (y < 0 || y >= S.H || x < 0 || x >= S.W) continue;
    long g = (long)y * S.P + x;
    #pragma unroll
    for (int k = 0; k < 4; ++k) __stcg(S.c[k] + g, T.c[k][i]);
    float ev = T.e[i];
    __stcg(S.e + g, ev);
    bool busy = ev > 0.0f && T.h[i] < INF_F;
    if (in) {
      __stcg(S.h + g, T.h[i]);
      act |= busy;
    } else if (busy) {
      if (ly == 0) top = true;
      else if (ly == T.TH + 1) bot = true;
      else if (lx == CX - 1) lft = true;
      else rgt = true;
    }
  }
  act = __syncthreads_or(act);
  top = __syncthreads_or(top);
  bot = __syncthreads_or(bot);
  lft = __syncthreads_or(lft);
  rgt = __syncthreads_or(rgt);
  if (threadIdx.x == 0) {
    int t = ty * ntx + tx;
    tact[t] = act ? 1 : 0;
    if (top && ty > 0) tact[t - ntx] = 1;
    if (bot && ty + 1 < nty) tact[t + ntx] = 1;
    if (lft && tx > 0) tact[t - 1] = 1;
    if (rgt && tx + 1 < ntx) tact[t + 1] = 1;
    atomicAdd(S.flags + F_TILES, 1);
  }
}

// One outer round: `phases` push/relabel phases over the active tiles
// (blocks of TILED_LOCAL_PHASES phases per tile visit, the tiles of one
// colour at a time, a grid barrier after each colour), then one BFS (seed,
// tile rounds until nothing changes), then the work test and the
// active-tile flags for the next round.
__global__ void __launch_bounds__(THREADS)
tiled_round_kernel(State S, TiledGeom G, int* tact, int phases, int n_pass) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  // the push tile and, once the push block is over, the BFS tile and its
  // distances share the shared memory
  PushTile T = push_carve(smem, G.TH, G.TW);
  BfsTile B = bfs_carve(reinterpret_cast<uint32_t*>(smem), G.BH, G.NWB);
  int* dist = reinterpret_cast<int*>(smem) + bfs_smem_words(G.BH, G.NWB);
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    S.flags[F_WORK] = 0;
    for (int r = 0; r < 3; ++r) S.flags[F_ROUND + r] = 0;
  }
  unsigned long long t_ns = global_ns();
  for (int done = 0; done < phases; done += TILED_LOCAL_PHASES) {
    const int k_here = min(TILED_LOCAL_PHASES, phases - done);
    for (int col = 0; col < 4; ++col) {
      const int cy = col >> 1, cx = col & 1;
      const int nyc = (G.nty - cy + 1) / 2, nxc = (G.ntx - cx + 1) / 2;
      for (int j = blockIdx.x; j < nyc * nxc; j += gridDim.x) {
        const int ty = 2 * (j / nxc) + cy, tx = 2 * (j % nxc) + cx;
        const int t = ty * G.ntx + tx;
        if (!__syncthreads_or(threadIdx.x == 0 && __ldcg(tact + t) != 0))
          continue;
        T.y0 = ty * G.TH;
        T.x0 = tx * G.TW;
        load_tile(T, S);
        Box box = active_box(T);
        // the visit ends early once no cell of the tile can push
        for (int ph = 0; ph < k_here && box.r0 <= box.r1; ++ph) {
          push_substeps(T, box);
          if (!relabel(T, box)) break;
        }
        store_tile(T, S, tact, ty, tx, G.nty, G.ntx);
      }
      grid.sync();
    }
  }

  add_ns(S.flags, F_PUSH_NS, &t_ns);
  bfs_seed_global(S);
  grid.sync();
  // With one BFS tile per CTA the tile's distances stay in shared memory
  // from round to round and reach device memory at the end (its edge
  // cells at once, for the neighbours); else every visit reloads them.
  const int BW = 32 * G.NWB, n_bt = G.nby * G.nbx;
  const bool keep = n_bt <= (int)gridDim.x;
  auto load_tile_bits = [&](int t) {
    const int by = t / G.nbx, bx = t % G.nbx;
    for (int w = threadIdx.x; w < G.BH * G.NWB; w += blockDim.x) {
      const int y = by * G.BH + w / G.NWB, gw = bx * G.NWB + w % G.NWB;
      const bool in = y < S.H && gw < S.NWg;
      const long g = (long)y * S.NWg + gw;
      #pragma unroll
      for (int k = 0; k < 4; ++k) B.op[k][w] = in ? __ldcg(S.bits[k] + g) : 0u;
      B.sink[w] = in ? __ldcg(S.bits[4] + g) : 0u;
    }
    bfs_forget_halo(B);
  };
  // tile t's distances between shared (rows of BW + 1, so that the lanes
  // of a warp, one per row, hit distinct banks) and device memory
  const int DP = BW + 1;
  auto tile_dist = [&](int t, bool to_device) {
    const int y0 = (t / G.nbx) * G.BH, x0 = (t % G.nbx) * BW;
    for (int i = threadIdx.x; i < G.BH * BW; i += blockDim.x) {
      const int ry = i / BW, x = i % BW, y = y0 + ry, xg = x0 + x;
      const bool in = y < S.H && xg < S.W;
      const long g = (long)y * S.P + xg;
      int& d = dist[ry * DP + x];
      if (to_device) {
        if (in) __stcg(S.h + g, d < INF_I ? (float)d : INF_F);
      } else {
        d = in ? height_to_int(__ldcg(S.h + g)) : INF_I;
      }
    }
  };
  int levels = 0;
  if (keep && (int)blockIdx.x < n_bt) {
    load_tile_bits(blockIdx.x);
    tile_dist(blockIdx.x, false);   // the seed: 0 at sinks, INF elsewhere
  }
  __syncthreads();
  bfs_rounds(grid, S, n_bt, n_pass, [&](int t, int r) -> bool {
    const int y0 = (t / G.nbx) * G.BH, x0 = (t % G.nbx) * BW;
    if (!keep) {
      load_tile_bits(t);
      tile_dist(t, false);
      __syncthreads();
    }
    bfs_load_halo(B, S, y0, x0);
    const bool drop = bfs_tile(
        B, r == 0, [&](int ry, int x) { return dist[ry * DP + x]; },
        [&](int ry, int x, int v) {
          dist[ry * DP + x] = v;
          if (ry == 0 || ry == G.BH - 1 || x == 0 || x == BW - 1)
            __stcg(S.h + (long)(y0 + ry) * S.P + x0 + x, (float)v);
        },
        &levels);
    if (!keep) tile_dist(t, true);
    return drop;
  });
  if (keep && (int)blockIdx.x < n_bt) tile_dist(blockIdx.x, true);
  if ((threadIdx.x & 31) == 0) atomicAdd(S.flags + F_LEVELS, levels);
  grid.sync();
  add_ns(S.flags, F_BFS_NS, &t_ns);

  // work test and the active tiles of the next push block
  for (int t = blockIdx.x; t < G.nty * G.ntx; t += gridDim.x) {
    const int y0 = (t / G.ntx) * G.TH, x0 = (t % G.ntx) * G.TW;
    bool act = false;
    for (int i = threadIdx.x; i < G.TH * G.TW; i += blockDim.x) {
      const int y = y0 + i / G.TW, x = x0 + i % G.TW;
      if (y >= S.H || x >= S.W) continue;
      const long g = (long)y * S.P + x;
      act |= __ldcg(S.e + g) > 0.0f && __ldcg(S.h + g) < INF_F;
    }
    act = __syncthreads_or(act);
    if (threadIdx.x == 0) {
      tact[t] = act ? 1 : 0;
      if (act) atomicOr(S.flags + F_WORK, 1);
    }
  }
}

inline TiledGeom tiled_geom(int H, int W) {
  TiledGeom G;
  G.TH = TILED_TH;
  G.TW = TILED_TW;
  G.nty = (H + G.TH - 1) / G.TH;
  G.ntx = (W + G.TW - 1) / G.TW;
  G.BH = TILED_BH;
  G.NWB = TILED_NWB;
  G.nby = (H + G.BH - 1) / G.BH;
  G.nbx = (W + 32 * G.NWB - 1) / (32 * G.NWB);
  return G;
}

// floats of scratch the tiled solver needs beyond the state: the active
// flags of the push tiles
inline long tiled_extra_floats(int H, int W) {
  TiledGeom G = tiled_geom(H, W);
  return (long)G.nty * G.ntx;
}

inline cudaError_t tiled_solve(const float* cap_h, const float* cap_v,
                               const float* exc, const uint8_t* node,
                               uint8_t* side, float* dist, float* work,
                               int* flags, int H, int W, int max_outer,
                               int inner_iters, int sweep_iters,
                               cudaStream_t stream, long long* stats) {
  State S = carve_state(work, node, flags, H, W);
  int* tact = reinterpret_cast<int*>(work + state_floats(H, W));
  TiledGeom G = tiled_geom(H, W);
  const size_t bfs_bytes =
      ((size_t)bfs_smem_words(G.BH, G.NWB) +
       (size_t)G.BH * (32 * G.NWB + 1)) * sizeof(uint32_t);
  const size_t smem = bfs_bytes > push_smem_bytes(G.TH, G.TW)
                          ? bfs_bytes : push_smem_bytes(G.TH, G.TW);
  int ctas = 0;
  cudaError_t err = coop_capacity(tiled_round_kernel, smem, &ctas);
  if (err != cudaSuccess) return err;
  if (ctas < 1) return cudaErrorCooperativeLaunchTooLarge;
  HostLoop L;
  L.s = stream;
  L.flags = flags;
  auto round = [&](bool first) -> cudaError_t {
    int phases = first ? 0 : inner_iters;
    void* args[] = {&S, &G, &tact, &phases, &sweep_iters};
    cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)tiled_round_kernel, dim3(ctas), dim3(THREADS), args,
        smem, stream);
    if (e != cudaSuccess) return e;
    return L.check();
  };
  return solve_loop(S, L, cap_h, cap_v, exc, side, dist, max_outer, round,
                    stats);
}

}  // namespace spt
