// Min s-t cut of a 4-connected seam grid by tiled push-relabel, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces simplepanorama_tpu/ops/maxflow.py::_mincut_tiled_kernel (the
// Pallas kernel behind grid_mincut_pallas_tiled), which the seam graph cut
// runs on grids of more than 1.2M cells. What it computes is the same min
// cut as csrc/mincut.cu: t-links folded into a signed excess clipped to the
// incident capacity sum + 1; outer rounds of `inner_iters` push/relabel
// phases, then one global-relabel BFS (distance to the nearest sink through
// positive residual edges) that gives the next heights and the termination
// test; the source side is the set of nodes that cannot reach a sink.
//
// Design for this card. The TPU kernel streams full-width row tiles through
// VMEM one after another; one row of its 7 f32 planes at 1408 columns is
// 39 KB, and an SM has 227 KB of shared memory. Here the state (4 residual
// capacities, excess, heights/distances, one byte of open directions per
// cell) stays in device memory and every CTA works one 2-D tile in shared
// memory:
//
// * Push phase. A CTA loads a 32x128 tile with a 1-cell halo (7 f32 planes
//   and the node mask, 128 KB of dynamic shared memory), runs the 4 push
//   sub-steps lock-step over the tile (every flow of a sub-step is computed
//   from the state before it, into a flow plane, then applied) and the
//   relabel, and stores the tile with the halo cells that received flow.
//   Only interior cells push or lift; halo cells only receive.
// * Race-free schedule. The TPU kernel makes cross-tile flow exact by
//   running its tiles in sequence (maxflow.py:398-409). Concurrent CTAs
//   break that argument, and with 2-D tiles two diagonal neighbours would
//   both write the corner cell of a tile they share as an edge neighbour.
//   So the tiles are coloured by (tile row mod 2, tile column mod 2) and
//   the four colours run as four launches in sequence. Two tiles of one
//   colour are at least two tiles apart, so the cells one CTA reads or
//   writes (its tile and the edge-adjacent halo cells) are touched by no
//   other live CTA. Each launch is then the same as running its tiles one
//   after another, and a phase as a whole is a sequential tile order like
//   the TPU kernel's: every height a tile reads from a neighbour is the
//   neighbour's current one.
// * Idle-tile skip. A CTA first reads its interior excess; if no node in it
//   has positive excess (no push can start there, maxflow.py:564-580), it
//   exits before loading anything else.
// * BFS. A prep pass seeds the distances (0 at nodes with negative excess,
//   INF elsewhere) and packs the 4 "residual capacity > 0" bits per cell.
//   Each round launches one CTA per 64x128 tile; a CTA loads its distances
//   with the 1-cell halo as fixed boundary values and runs down/up/right/
//   left min-plus scans (one warp per line, the (B, A) combine of
//   maxflow.py::_minplus_scan by warp shuffles) until a pass changes
//   nothing, then stores the distances that decreased and sets a device
//   flag. The host reads the flag once per round and stops after a round
//   that changed nothing. All tiles of a round run at once: a tile may read
//   a neighbour's halo before or after that neighbour writes it, but every
//   value it can read is the length of a real path, distances only
//   decrease, and a round in which nothing changed saw a constant state, so
//   its local fixpoints make a global one.
//
// Bound: a push launch reads ~25 B and writes ~24 B per cell of its active
// tiles; a BFS round reads 5 B per cell. Neither is the limit: on an H100
// 80GB HBM3 at 700 W a push launch took 18-21 us at every block size from
// 0.4M to 2.6M cells (one wave of CTAs, each loading 128 KB and passing
// eleven barriers: latency), and a BFS round 220-290 us, 49-65% of the
// solver's device time. A persistent cooperative kernel (a grid barrier
// between colours), fewer BFS rounds (larger BFS tiles), asynchronous
// copies of the next tile, or a CUDA graph of one outer round are the
// later work.
//
// Built with -fmad=false so every multiply and add rounds like the plain
// PyTorch version (ops/maxflow.py::grid_mincut_tiled_ref).

#include <cuda_runtime.h>
#include <stdint.h>

#define SPT_INF 1e18f
#define FULL_MASK 0xffffffffu

namespace {

// push tiles: interior TH x TW, stored with a 1-cell halo
constexpr int TH = 32, TW = 128;
constexpr int PH = TH + 2, PW = TW + 2, PN = PH * PW;
constexpr int PUSH_THREADS = 512;
constexpr size_t PUSH_SMEM = (size_t)PN * (7 * sizeof(float) + 1);

// BFS tiles
constexpr int BH = 64, BW = 128;
constexpr int BPH = BH + 2, BPW = BW + 2, BPN = BPH * BPW;
constexpr int BFS_THREADS = 256;

// direction order: 0=right(+x), 1=left(-x), 2=down(+y), 3=up(-y)
__host__ __device__ inline int dir_dy(int k) { return k == 2 ? 1 : (k == 3 ? -1 : 0); }
__host__ __device__ inline int dir_dx(int k) { return k == 0 ? 1 : (k == 1 ? -1 : 0); }

struct Planes {
  float* c[4];          // residual capacity toward each neighbour
  float* e;             // excess
  float* h;             // heights in the push phases, distances in the BFS
  uint8_t* open;        // bit k: c[k] > 0 (BFS only)
  const uint8_t* node;  // 0/1
  int H, W;
};

__global__ void init_kernel(const float* __restrict__ cap_h,
                            const float* __restrict__ cap_v,
                            const float* __restrict__ exc, Planes S) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  int H = S.H, W = S.W;
  if (x >= W || y >= H) return;
  long p = (long)y * W + x;
  const uint8_t* node = S.node;
  float nf = node[p] ? 1.0f : 0.0f;
  // left/up edges live at the neighbour's index in cap_h/cap_v
  float r = (x + 1 < W) ? cap_h[p] * nf * (node[p + 1] ? 1.0f : 0.0f) : 0.0f;
  float l = (x > 0) ? cap_h[p - 1] * (node[p - 1] ? 1.0f : 0.0f) * nf : 0.0f;
  float d = (y + 1 < H) ? cap_v[p] * nf * (node[p + W] ? 1.0f : 0.0f) : 0.0f;
  float u = (y > 0) ? cap_v[p - W] * (node[p - W] ? 1.0f : 0.0f) * nf : 0.0f;
  S.c[0][p] = r;
  S.c[1][p] = l;
  S.c[2][p] = d;
  S.c[3][p] = u;
  float ev = node[p] ? exc[p] : 0.0f;
  float cs = r + l + d + u + 1.0f;
  S.e[p] = fminf(fmaxf(ev, -cs), cs);
}

// One push/relabel phase over the tiles of colour (cy, cx).
__global__ void __launch_bounds__(PUSH_THREADS)
push_kernel(Planes S, int cy, int cx) {
  extern __shared__ float sm[];
  float* cs[4] = {sm, sm + PN, sm + 2 * PN, sm + 3 * PN};
  float* e = sm + 4 * PN;
  float* h = sm + 5 * PN;
  float* fl = sm + 6 * PN;
  uint8_t* nd = reinterpret_cast<uint8_t*>(sm + 7 * PN);
  const int H = S.H, W = S.W;
  const int ty = 2 * blockIdx.y + cy, tx = 2 * blockIdx.x + cx;
  const int y0 = ty * TH - 1, x0 = tx * TW - 1;   // grid coords of (0, 0)

  // the peek: positive excess at an interior node?
  int act = 0;
  for (int i = threadIdx.x; i < TH * TW; i += PUSH_THREADS) {
    int y = ty * TH + i / TW, x = tx * TW + i % TW;
    if (y < H && x < W) {
      long p = (long)y * W + x;
      if (S.node[p] && S.e[p] > 0.0f) act = 1;
    }
  }
  if (!__syncthreads_or(act)) return;

  for (int i = threadIdx.x; i < PN; i += PUSH_THREADS) {
    int ly = i / PW, lx = i % PW, y = y0 + ly, x = x0 + lx;
    bool corner = (ly == 0 || ly == PH - 1) && (lx == 0 || lx == PW - 1);
    if (!corner && y >= 0 && y < H && x >= 0 && x < W) {
      long p = (long)y * W + x;
#pragma unroll
      for (int k = 0; k < 4; ++k) cs[k][i] = S.c[k][p];
      e[i] = S.e[p];
      h[i] = S.h[p];
      nd[i] = S.node[p];
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) cs[k][i] = 0.0f;
      e[i] = 0.0f;
      h[i] = SPT_INF;
      nd[i] = 0;
    }
  }
  __syncthreads();

  const int rev[4] = {1, 0, 3, 2};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int off = dir_dy(k) * PW + dir_dx(k);
    float* ck = cs[k];
    float* cr = cs[rev[k]];
    // flows of this sub-step, all from the state before it
    for (int i = threadIdx.x; i < PN; i += PUSH_THREADS) {
      int ly = i / PW, lx = i % PW;
      float f = 0.0f;
      if (ly >= 1 && ly <= TH && lx >= 1 && lx <= TW) {
        float ep = e[i], cp = ck[i];
        if (ep > 0.0f && h[i] == h[i + off] + 1.0f && cp > 0.0f)
          f = fminf(ep, cp);
      }
      fl[i] = f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < PN; i += PUSH_THREADS) {
      int ly = i / PW, lx = i % PW;
      int qy = ly - dir_dy(k), qx = lx - dir_dx(k);
      float f = fl[i];
      float b = (qy >= 0 && qy < PH && qx >= 0 && qx < PW) ? fl[i - off]
                                                           : 0.0f;
      ck[i] = ck[i] - f;
      cr[i] = cr[i] + b;
      e[i] = e[i] - f + b;
    }
    __syncthreads();
  }

  // relabel: an active interior cell with no admissible edge lifts to
  // 1 + the lowest neighbour height it has residual capacity toward
  for (int i = threadIdx.x; i < PN; i += PUSH_THREADS) {
    int ly = i / PW, lx = i % PW;
    float hp = h[i], hn = hp;
    if (ly >= 1 && ly <= TH && lx >= 1 && lx <= TW && e[i] > 0.0f) {
      float min_h = SPT_INF;
      bool adm = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float nb = h[i + dir_dy(k) * PW + dir_dx(k)];
        bool has_cap = cs[k][i] > 0.0f;
        min_h = fminf(min_h, has_cap ? nb : SPT_INF);
        adm = adm || (has_cap && hp == nb + 1.0f);
      }
      if (!adm && min_h < SPT_INF) hn = min_h + 1.0f;
    }
    fl[i] = hn;
  }
  __syncthreads();

  // store the tile and its edge halo (the cells that may have received
  // flow); no other live CTA touches any of them
  for (int i = threadIdx.x; i < PN; i += PUSH_THREADS) {
    int ly = i / PW, lx = i % PW, y = y0 + ly, x = x0 + lx;
    bool corner = (ly == 0 || ly == PH - 1) && (lx == 0 || lx == PW - 1);
    if (corner || y < 0 || y >= H || x < 0 || x >= W) continue;
    long p = (long)y * W + x;
#pragma unroll
    for (int k = 0; k < 4; ++k) S.c[k][p] = cs[k][i];
    S.e[p] = e[i];
    if (ly >= 1 && ly <= TH && lx >= 1 && lx <= TW) S.h[p] = fl[i];
  }
}

// BFS seed and the open-direction bits
__global__ void bfs_prep_kernel(Planes S) {
  long n = (long)S.H * S.W;
  long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  bool nd = S.node[p] != 0;
  S.h[p] = (nd && S.e[p] < 0.0f) ? 0.0f : SPT_INF;
  uint8_t b = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (nd && S.c[k][p] > 0.0f) b |= (uint8_t)(1u << k);
  S.open[p] = b;
}

// Inclusive min-plus scan of one line by one warp, in shared memory:
// d[i] = min(d[i], d[i-1] + w[i]) with w[i] = 1 where bit `bit` of the
// cell admits the step into it from its predecessor, INF where not. The
// predecessor of the first element holds `carry`. Returns whether a
// distance decreased (in this lane).
__device__ bool warp_scan(float* d, const uint8_t* bits, int base, int stride,
                          int len, int bit, float carry) {
  const int lane = threadIdx.x & 31;
  bool dec = false;
  for (int c0 = 0; c0 < len; c0 += 32) {
    int i = c0 + lane;
    bool in = i < len;
    int idx = base + i * stride;
    float old = in ? d[idx] : SPT_INF;
    float B = old;
    float A = (in && ((bits[idx] >> bit) & 1)) ? 1.0f : SPT_INF;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float Bp = __shfl_up_sync(FULL_MASK, B, off);
      float Ap = __shfl_up_sync(FULL_MASK, A, off);
      if (lane >= off) {
        B = fminf(B, Bp + A);
        A = fminf(Ap + A, SPT_INF);
      }
    }
    float dn = fminf(B, carry + A);
    if (in && dn < old) {
      d[idx] = dn;
      dec = true;
    }
    carry = __shfl_sync(FULL_MASK, dn, 31);
  }
  return dec;
}

// One BFS round over every tile; sets *changed when a distance decreased.
__global__ void __launch_bounds__(BFS_THREADS)
bfs_kernel(Planes S, int n_pass, int* __restrict__ changed) {
  __shared__ float d[BPN];
  __shared__ uint8_t bits[BPN];
  const int H = S.H, W = S.W;
  const int y0 = blockIdx.y * BH - 1, x0 = blockIdx.x * BW - 1;
  for (int i = threadIdx.x; i < BPN; i += BFS_THREADS) {
    int ly = i / BPW, lx = i % BPW, y = y0 + ly, x = x0 + lx;
    bool in = y >= 0 && y < H && x >= 0 && x < W;
    bool interior = ly >= 1 && ly <= BH && lx >= 1 && lx <= BW;
    long p = (long)y * W + x;
    d[i] = in ? S.h[p] : SPT_INF;
    bits[i] = (in && interior) ? S.open[p] : 0;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, nw = BFS_THREADS / 32;
  bool any_dec = false;
  for (int pass = 0; pass < n_pass; ++pass) {
    bool dec = false;
    // values flow down: the step into p from above is open iff p can push
    // up (bit 3); then up (bit 2), right (bit 1), left (bit 0)
    for (int lx = 1 + warp; lx <= BW; lx += nw)
      dec |= warp_scan(d, bits, BPW + lx, BPW, BH, 3, d[lx]);
    __syncthreads();
    for (int lx = 1 + warp; lx <= BW; lx += nw)
      dec |= warp_scan(d, bits, BH * BPW + lx, -BPW, BH, 2,
                       d[(BPH - 1) * BPW + lx]);
    __syncthreads();
    for (int ly = 1 + warp; ly <= BH; ly += nw)
      dec |= warp_scan(d, bits, ly * BPW + 1, 1, BW, 1, d[ly * BPW]);
    __syncthreads();
    for (int ly = 1 + warp; ly <= BH; ly += nw)
      dec |= warp_scan(d, bits, ly * BPW + BW, -1, BW, 0,
                       d[ly * BPW + BPW - 1]);
    if (!__syncthreads_or(dec)) break;
    any_dec = true;
  }
  if (!any_dec) return;   // block-uniform
  for (int i = threadIdx.x; i < BPN; i += BFS_THREADS) {
    int ly = i / BPW, lx = i % BPW, y = y0 + ly, x = x0 + lx;
    if (ly < 1 || ly > BH || lx < 1 || lx > BW || y >= H || x >= W) continue;
    long p = (long)y * W + x;
    if (d[i] < S.h[p]) S.h[p] = d[i];
  }
  if (threadIdx.x == 0) atomicExch(changed, 1);
}

// flag = any(node & e > 0 & d < INF): positive excess that can still
// reach a sink
__global__ void work_kernel(Planes S, int* __restrict__ flag) {
  long n = (long)S.H * S.W;
  long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  int w = (p < n && S.node[p] && S.e[p] > 0.0f && S.h[p] < SPT_INF) ? 1 : 0;
  if (__syncthreads_or(w) && threadIdx.x == 0) atomicExch(flag, 1);
}

__global__ void side_kernel(Planes S, uint8_t* __restrict__ side) {
  long n = (long)S.H * S.W;
  long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) side[p] = (S.h[p] >= SPT_INF && S.node[p]) ? 1 : 0;
}

struct Solver {
  Planes S;
  cudaStream_t s;
  int* flags;       // [0] BFS changed, [1] work left
  int n_pass;
  int grd1;
  dim3 bfs_grid;
  long kernels = 0;
  long bfs_rounds = 0;

  cudaError_t check() {
    ++kernels;
    return cudaGetLastError();
  }

  cudaError_t read_flag(int i, int* out) {
    cudaError_t err = cudaMemcpyAsync(out, flags + i, sizeof(int),
                                      cudaMemcpyDeviceToHost, s);
    if (err != cudaSuccess) return err;
    return cudaStreamSynchronize(s);
  }

  // global relabel into S.h; returns work-left in *work
  cudaError_t bfs(int* work) {
    cudaError_t err;
    bfs_prep_kernel<<<grd1, 256, 0, s>>>(S);
    if ((err = check()) != cudaSuccess) return err;
    for (int r = 0; r < n_pass; ++r) {
      if ((err = cudaMemsetAsync(flags, 0, sizeof(int), s)) != cudaSuccess)
        return err;
      bfs_kernel<<<bfs_grid, BFS_THREADS, 0, s>>>(S, n_pass, flags);
      if ((err = check()) != cudaSuccess) return err;
      ++bfs_rounds;
      int changed = 0;
      if ((err = read_flag(0, &changed)) != cudaSuccess) return err;
      if (!changed) break;
    }
    if ((err = cudaMemsetAsync(flags + 1, 0, sizeof(int), s)) != cudaSuccess)
      return err;
    work_kernel<<<grd1, 256, 0, s>>>(S, flags + 1);
    if ((err = check()) != cudaSuccess) return err;
    return read_flag(1, work);
  }

  cudaError_t phase() {
    const int nty = (S.H + TH - 1) / TH, ntx = (S.W + TW - 1) / TW;
    for (int cy = 0; cy < 2; ++cy)
      for (int cx = 0; cx < 2; ++cx) {
        dim3 grd((ntx - cx + 1) / 2, (nty - cy + 1) / 2);
        if (grd.x == 0 || grd.y == 0) continue;
        push_kernel<<<grd, PUSH_THREADS, PUSH_SMEM, s>>>(S, cy, cx);
        cudaError_t err = check();
        if (err != cudaSuccess) return err;
      }
    return cudaSuccess;
  }
};

}  // namespace

extern "C" {

// Solve one grid. Inputs (H, W) row-major: cap_h, cap_v, excess (float32),
// node (uint8 0/1). Output side (uint8 0/1). `work` is caller-allocated
// scratch of 7*H*W floats, `flags` of 2 ints, both on the device. Runs on
// `stream`; returns a cudaError_t code (0 on success). stats (host) gets
// {outer rounds, BFS rounds, kernel launches}.
int spt_grid_mincut_tiled(const float* cap_h, const float* cap_v,
                          const float* exc, const uint8_t* node,
                          uint8_t* side, float* work, int* flags, int H,
                          int W, int max_outer, int inner_iters,
                          int sweep_iters, void* stream, long long* stats) {
  cudaError_t err = cudaFuncSetAttribute(
      push_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PUSH_SMEM);
  if (err != cudaSuccess) return (int)err;
  Solver V;
  long n = (long)H * W;
  for (int k = 0; k < 4; ++k) V.S.c[k] = work + (long)k * n;
  V.S.e = work + 4 * n;
  V.S.h = work + 5 * n;
  V.S.open = reinterpret_cast<uint8_t*>(work + 6 * n);
  V.S.node = node;
  V.S.H = H;
  V.S.W = W;
  V.s = (cudaStream_t)stream;
  V.flags = flags;
  V.n_pass = sweep_iters;
  V.grd1 = (int)((n + 255) / 256);
  V.bfs_grid = dim3((W + BW - 1) / BW, (H + BH - 1) / BH);

  dim3 blk2(32, 8), grd2((W + 31) / 32, (H + 7) / 8);
  init_kernel<<<grd2, blk2, 0, V.s>>>(cap_h, cap_v, exc, V.S);
  if ((err = V.check()) != cudaSuccess) return (int)err;

  // one BFS per outer round: its distances are both the heights for the
  // next push block and the termination test of the previous one
  int work_left = 0;
  if ((err = V.bfs(&work_left)) != cudaSuccess) return (int)err;
  int it = 0;
  while (it < max_outer && work_left) {
    for (int i = 0; i < inner_iters; ++i)
      if ((err = V.phase()) != cudaSuccess) return (int)err;
    if ((err = V.bfs(&work_left)) != cudaSuccess) return (int)err;
    ++it;
  }
  side_kernel<<<V.grd1, 256, 0, V.s>>>(V.S, side);
  if ((err = V.check()) != cudaSuccess) return (int)err;
  if (stats) {
    stats[0] = it;
    stats[1] = V.bfs_rounds;
    stats[2] = V.kernels;
  }
  return 0;
}

const char* spt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
