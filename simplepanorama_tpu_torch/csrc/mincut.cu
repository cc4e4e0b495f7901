// Min s-t cut of a 4-connected seam grid by lock-step push-relabel, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces simplepanorama_tpu/ops/maxflow.py::_mincut_kernel (the Pallas
// kernel behind grid_mincut_pallas). What it computes is the same: t-links
// folded into a signed excess clipped to the incident capacity sum + 1;
// outer rounds of `inner_iters` push/relabel phases (4 directions each, in
// the order right, left, down, up, every direction lock-step); then one
// global-relabel BFS (distance to the nearest sink through positive
// residual edges) that doubles as the termination test. The output is the
// source side: node cells that cannot reach a sink.
//
// Design for this card. The TPU kernel keeps the whole grid in VMEM for
// one launch; a Hopper SM has 227 KB of shared memory, so here the ~12 f32
// state planes (4 residual capacities and their ping-pong twins, excess
// twice, heights twice, BFS distances) live in device memory. At the
// 640x640 blocks of a 12-view 700-px stitch that is ~20 MB, inside the
// 50 MB L2, so every pass streams from L2. Each push direction is ONE
// kernel: a thread computes its own outgoing flow and, from the same
// (unchanged) inputs, the flow its upstream neighbour sends it; excess and
// the pushed capacity plane are written to ping-pong buffers so no thread
// reads a value another thread has already updated (the semantics stay
// lock-step, exactly maxflow.py:314-321). The BFS runs per-row and
// per-column min-plus scans, one warp per line, with the (B, A) combine
// of maxflow.py::_minplus_scan done by warp shuffles; heights are
// integer-valued floats, so the distances equal the doubling scan's.
//
// Bound: with ~150 launches of small elementwise kernels per outer round
// and one host read-back per BFS pass and per round, the solver is bound
// by launch latency and L2 bandwidth, not by arithmetic. A persistent
// cooperative kernel (grid-wide sync between phases), or a CUDA graph of
// one outer iteration, is the later work that removes the launch cost.
//
// Built with -fmad=false so every multiply and add rounds like the plain
// PyTorch version (ops/maxflow.py::grid_mincut_ref).

#include <cuda_runtime.h>
#include <stdint.h>

#define SPT_INF 1e18f
#define FULL_MASK 0xffffffffu

namespace {

// direction order: 0=right(+x), 1=left(-x), 2=down(+y), 3=up(-y)
__host__ __device__ inline int dir_dy(int k) { return k == 2 ? 1 : (k == 3 ? -1 : 0); }
__host__ __device__ inline int dir_dx(int k) { return k == 0 ? 1 : (k == 1 ? -1 : 0); }

__global__ void init_kernel(const float* __restrict__ cap_h,
                            const float* __restrict__ cap_v,
                            const float* __restrict__ exc,
                            const uint8_t* __restrict__ node,
                            float* __restrict__ c0, float* __restrict__ c1,
                            float* __restrict__ c2, float* __restrict__ c3,
                            float* __restrict__ e, int H, int W) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  long p = (long)y * W + x;
  float nf = node[p] ? 1.0f : 0.0f;
  // residual capacity from p toward each neighbour; left/up edges live at
  // the neighbour's index in cap_h/cap_v (maxflow.py:165-172)
  float r = (x + 1 < W) ? cap_h[p] * nf * (node[p + 1] ? 1.0f : 0.0f) : 0.0f;
  float l = (x > 0) ? cap_h[p - 1] * (node[p - 1] ? 1.0f : 0.0f) * nf : 0.0f;
  float d = (y + 1 < H) ? cap_v[p] * nf * (node[p + W] ? 1.0f : 0.0f) : 0.0f;
  float u = (y > 0) ? cap_v[p - W] * (node[p - W] ? 1.0f : 0.0f) * nf : 0.0f;
  c0[p] = r;
  c1[p] = l;
  c2[p] = d;
  c3[p] = u;
  float ev = node[p] ? exc[p] : 0.0f;
  float cs = r + l + d + u + 1.0f;
  e[p] = fminf(fmaxf(ev, -cs), cs);
}

// one push sub-step of direction k (dy, dx), lock-step over the grid
__global__ void push_kernel(const float* __restrict__ e_in,
                            float* __restrict__ e_out,
                            const float* __restrict__ ck_in,
                            float* __restrict__ ck_out,
                            float* __restrict__ crev,
                            const float* __restrict__ h,
                            int dy, int dx, int H, int W) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  long p = (long)y * W + x;
  float ep = e_in[p];
  float cp = ck_in[p];
  float hp = h[p];
  // own outgoing flow toward (y+dy, x+dx)
  int yn = y + dy, xn = x + dx;
  float hn = (yn >= 0 && yn < H && xn >= 0 && xn < W) ? h[(long)yn * W + xn]
                                                      : SPT_INF;
  float flow = (ep > 0.0f && hp == hn + 1.0f && cp > 0.0f) ? fminf(ep, cp)
                                                           : 0.0f;
  // flow received from the upstream neighbour (y-dy, x-dx), whose target
  // height is this cell's
  int yq = y - dy, xq = x - dx;
  float back = 0.0f;
  if (yq >= 0 && yq < H && xq >= 0 && xq < W) {
    long q = (long)yq * W + xq;
    float eq = e_in[q];
    float cq = ck_in[q];
    float hq = h[q];
    if (eq > 0.0f && hq == hp + 1.0f && cq > 0.0f) back = fminf(eq, cq);
  }
  ck_out[p] = cp - flow;
  crev[p] = crev[p] + back;
  e_out[p] = ep - flow + back;
}

// relabel: active cells with no admissible edge lift to 1 + the lowest
// residual neighbour height (maxflow.py:322-330)
__global__ void relabel_kernel(const float* __restrict__ c0,
                               const float* __restrict__ c1,
                               const float* __restrict__ c2,
                               const float* __restrict__ c3,
                               const float* __restrict__ e,
                               const float* __restrict__ h_in,
                               float* __restrict__ h_out, int H, int W) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  long p = (long)y * W + x;
  const float* caps[4] = {c0, c1, c2, c3};
  float hp = h_in[p];
  float min_h = SPT_INF;
  bool adm = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int yn = y + dir_dy(k), xn = x + dir_dx(k);
    float hn = (yn >= 0 && yn < H && xn >= 0 && xn < W)
                   ? h_in[(long)yn * W + xn] : SPT_INF;
    bool has_cap = caps[k][p] > 0.0f;
    min_h = fminf(min_h, has_cap ? hn : SPT_INF);
    adm = adm || (has_cap && hp == hn + 1.0f);
  }
  bool lift = (e[p] > 0.0f) && !adm && (min_h < SPT_INF);
  h_out[p] = lift ? min_h + 1.0f : hp;
}

__global__ void seed_kernel(const float* __restrict__ e,
                            const uint8_t* __restrict__ node,
                            float* __restrict__ d, int H, int W) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  long p = (long)y * W + x;
  d[p] = (node[p] && e[p] < 0.0f) ? 0.0f : SPT_INF;
}

// Inclusive min-plus scan along each of n_lines lines, one warp per line,
// in place: d[i] = min(d[i], d[i-1] + w[i]) with w[i] = 1 where the
// residual capacity `cap` admits a step into i from its predecessor, INF
// where not. Elements of line l sit at l*line_stride + i*elem_stride
// (reversed when `reverse`). With `mask_node`, cells outside the node set
// end at INF. Sets *changed when any distance decreased.
__global__ void scan_kernel(float* __restrict__ d,
                            const float* __restrict__ cap,
                            const uint8_t* __restrict__ node,
                            int n_lines, int len, long line_stride,
                            long elem_stride, int reverse, int mask_node,
                            int* __restrict__ changed) {
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= n_lines) return;   // warp-uniform
  float carry = SPT_INF;         // distance of the chunk's predecessor
  bool dec = false;
  for (int c0 = 0; c0 < len; c0 += 32) {
    int i = c0 + lane;
    bool in = i < len;
    long idx = (long)warp * line_stride
               + (long)(reverse ? (len - 1 - i) : i) * elem_stride;
    float old = in ? d[idx] : SPT_INF;
    float B = old;
    float A = (in && cap[idx] > 0.0f) ? 1.0f : SPT_INF;
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
    if (in) {
      if (mask_node && !node[idx]) dn = SPT_INF;
      if (dn < old) dec = true;
      d[idx] = dn;
    }
    carry = __shfl_sync(FULL_MASK, dn, 31);
  }
  if (__any_sync(FULL_MASK, dec) && lane == 0) atomicExch(changed, 1);
}

// flag = any(e > 0 & d < INF): positive excess that can still reach a sink
__global__ void work_kernel(const float* __restrict__ e,
                            const float* __restrict__ d, long n,
                            int* __restrict__ flag) {
  long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  int w = (p < n && e[p] > 0.0f && d[p] < SPT_INF) ? 1 : 0;
  if (__syncthreads_or(w) && threadIdx.x == 0) atomicExch(flag, 1);
}

__global__ void side_kernel(const float* __restrict__ d,
                            const uint8_t* __restrict__ node,
                            uint8_t* __restrict__ side, long n) {
  long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) side[p] = (d[p] >= SPT_INF && node[p]) ? 1 : 0;
}

struct Solver {
  int H, W;
  long n;
  cudaStream_t s;
  dim3 blk2, grd2;
  int blk1, grd1;
  const uint8_t* node;
  float* caps[4];
  float* caps_alt[4];
  float *e, *e_alt, *h, *h_alt, *d;
  int* flags;       // [0] BFS changed, [1] work left
  int n_pass;
  long kernels;
  long bfs_passes;

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

  // global relabel into d; returns work-left in *work
  cudaError_t bfs(int* work) {
    cudaError_t err;
    seed_kernel<<<grd2, blk2, 0, s>>>(e, node, d, H, W);
    if ((err = check()) != cudaSuccess) return err;
    const int threads = 256, wpb = threads / 32;
    int grd_cols = (W + wpb - 1) / wpb, grd_rows = (H + wpb - 1) / wpb;
    for (int pass = 0; pass < n_pass; ++pass) {
      if ((err = cudaMemsetAsync(flags, 0, sizeof(int), s)) != cudaSuccess)
        return err;
      // values flow down: weight into p from (y-1, x) admits iff p can
      // push up (caps[3]); then up (caps[2]), right (caps[1]), left (caps[0])
      scan_kernel<<<grd_cols, threads, 0, s>>>(d, caps[3], node, W, H, 1, W,
                                               0, 0, flags);
      if ((err = check()) != cudaSuccess) return err;
      scan_kernel<<<grd_cols, threads, 0, s>>>(d, caps[2], node, W, H, 1, W,
                                               1, 0, flags);
      if ((err = check()) != cudaSuccess) return err;
      scan_kernel<<<grd_rows, threads, 0, s>>>(d, caps[1], node, H, W, W, 1,
                                               0, 0, flags);
      if ((err = check()) != cudaSuccess) return err;
      scan_kernel<<<grd_rows, threads, 0, s>>>(d, caps[0], node, H, W, W, 1,
                                               1, 1, flags);
      if ((err = check()) != cudaSuccess) return err;
      ++bfs_passes;
      int changed = 0;
      if ((err = read_flag(0, &changed)) != cudaSuccess) return err;
      if (!changed) break;
    }
    if ((err = cudaMemsetAsync(flags + 1, 0, sizeof(int), s)) != cudaSuccess)
      return err;
    work_kernel<<<grd1, blk1, 0, s>>>(e, d, n, flags + 1);
    if ((err = check()) != cudaSuccess) return err;
    return read_flag(1, work);
  }

  cudaError_t phase() {
    cudaError_t err;
    const int rev[4] = {1, 0, 3, 2};
    for (int k = 0; k < 4; ++k) {
      push_kernel<<<grd2, blk2, 0, s>>>(e, e_alt, caps[k], caps_alt[k],
                                        caps[rev[k]], h, dir_dy(k),
                                        dir_dx(k), H, W);
      if ((err = check()) != cudaSuccess) return err;
      float* t = e; e = e_alt; e_alt = t;
      t = caps[k]; caps[k] = caps_alt[k]; caps_alt[k] = t;
    }
    relabel_kernel<<<grd2, blk2, 0, s>>>(caps[0], caps[1], caps[2], caps[3],
                                         e, h, h_alt, H, W);
    if ((err = check()) != cudaSuccess) return err;
    float* t = h; h = h_alt; h_alt = t;
    return cudaSuccess;
  }
};

}  // namespace

extern "C" {

// Solve one grid. Inputs (H, W) row-major: cap_h, cap_v, excess (float32),
// node (uint8 0/1). Output side (uint8 0/1). `work` is caller-allocated
// scratch of 13*H*W floats, `flags` of 2 ints, both on the device. Runs on
// `stream`; returns a cudaError_t code (0 on success). stats (host) gets
// {outer rounds, BFS passes, kernel launches}.
int spt_grid_mincut(const float* cap_h, const float* cap_v, const float* exc,
                    const uint8_t* node, uint8_t* side, float* work,
                    int* flags, int H, int W, int max_outer, int inner_iters,
                    int sweep_iters, void* stream, long long* stats) {
  Solver S;
  S.H = H;
  S.W = W;
  S.n = (long)H * W;
  S.s = (cudaStream_t)stream;
  S.blk2 = dim3(32, 8);
  S.grd2 = dim3((W + 31) / 32, (H + 7) / 8);
  S.blk1 = 256;
  S.grd1 = (int)((S.n + 255) / 256);
  S.node = node;
  for (int k = 0; k < 4; ++k) {
    S.caps[k] = work + (long)k * S.n;
    S.caps_alt[k] = work + (long)(4 + k) * S.n;
  }
  S.e = work + 8 * S.n;
  S.e_alt = work + 9 * S.n;
  S.h = work + 10 * S.n;
  S.h_alt = work + 11 * S.n;
  S.d = work + 12 * S.n;
  S.flags = flags;
  S.n_pass = sweep_iters;
  S.kernels = 0;
  S.bfs_passes = 0;

  cudaError_t err;
  init_kernel<<<S.grd2, S.blk2, 0, S.s>>>(cap_h, cap_v, exc, node, S.caps[0],
                                          S.caps[1], S.caps[2], S.caps[3],
                                          S.e, H, W);
  if ((err = S.check()) != cudaSuccess) return (int)err;

  // one BFS per outer round: its distances are both the heights for the
  // next push block and the termination test of the previous one
  int work_left = 0;
  if ((err = S.bfs(&work_left)) != cudaSuccess) return (int)err;
  int it = 0;
  while (it < max_outer && work_left) {
    err = cudaMemcpyAsync(S.h, S.d, S.n * sizeof(float),
                          cudaMemcpyDeviceToDevice, S.s);
    if (err != cudaSuccess) return (int)err;
    for (int i = 0; i < inner_iters; ++i)
      if ((err = S.phase()) != cudaSuccess) return (int)err;
    if ((err = S.bfs(&work_left)) != cudaSuccess) return (int)err;
    ++it;
  }
  side_kernel<<<S.grd1, S.blk1, 0, S.s>>>(S.d, node, side, S.n);
  if ((err = S.check()) != cudaSuccess) return (int)err;
  if (stats) {
    stats[0] = it;
    stats[1] = S.bfs_passes;
    stats[2] = S.kernels;
  }
  return 0;
}

const char* spt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
