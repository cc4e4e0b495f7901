// Bundle-adjustment normal equations accumulated from per-match streams,
// for Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces simplepanorama_tpu/ops/ba_kernel.py::assemble_streams (the
// Pallas kernel _kernel / _stream_block). What it computes is the same:
// for M matches with camera ids (mi, mj) and N cameras,
//
//   J_r = ai[:, r, :] at block mi  +  aj[:, r, :] at block mj   (r = 0, 1)
//   U   = sum_m J_0^T J_0 + J_1^T J_1                       (6N, 6N)
//   eA  = sum_m J_0^T r2[:, 0] + J_1^T r2[:, 1]             (6N,)
//   w0 = J_0 bp00 + J_1 bp10,  w1 = J_0 bp01 + J_1 bp11
//   z0 = w0 l00 + w1 l10,      z1 = w1 l11
//   YW  = sum_m z0^T z0 + z1^T z1                           (6N, 6N)
//   yeb = sum_m w0 g0 + w1 g1                               (6N,)
//
// (YW and yeb are zero without the Schur terms.) An id outside [0, N)
// contributes nothing, as the one-hot compare of the TPU kernel gives;
// mi == mj adds both blocks into the same one, as the masks do.
//
// Design for this card. The TPU kernel builds dense (512, 6N) J/W/Z tiles
// on chip and carries the four sums in VMEM across a sequential grid. A
// match touches only the 6x6 blocks (mi,mi), (mi,mj), (mj,mi), (mj,mj) and
// two 6-segments, so here nothing dense is built. Hopper's CTAs run at
// once and the outputs at N = 40 (2 x 240^2 f32, 460 KB) exceed one CTA's
// 227 KB of shared memory, so the sums are split by camera row block and
// by match slice, and reduced in a fixed order (deterministic, no
// atomics):
//
//  * partial_kernel, grid (N, S): CTA (a, s) owns the six rows of camera a
//    and the matches of slice s. Per tile of 256 matches it compacts, in
//    order, the matches touching a (warp ballots), stages each one's
//    segments at a and at its other camera in shared memory, and G groups
//    of 36 threads accumulate: thread (p, q) of group g adds every G-th
//    staged match to rows p, columns 6b + q of its group's copy of the
//    row block, so each address has one writer. The G copies are summed
//    in order into the slice's partial row block in device memory.
//  * reduce_kernel sums the S partials of each output element in order.
//
// Each multiply and add of a segment is the plain version's own
// (ops/ba_kernel.py::assemble_streams_ref, built with -fmad=false); the
// sums run in another order, so the outputs agree within
// 1e-3 * max|plain| + 1e-4, the TPU kernel's own test bound.
//
// Bound: a match reads 37 four-byte values (148 B) and needs ~1.4 kFLOP
// at N = 40; M = 20,480 matches read 3.0 MB and write 0.46 MB, ~1 us of
// HBM time against ~0.4 us of f32 arithmetic: memory-bound on paper,
// launch-bound in practice (two launches of a few microseconds each). The
// partial row blocks (S * N * (72N + 12) floats, 3.2 MB at N = 40) stay
// in the 50 MB L2 between the two launches.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;       // matches per tile, one per thread
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUPS = THREADS / 36;   // 7 groups of 36 threads
constexpr int TARGET_CTAS = 264;           // two CTAs per SM of 132
constexpr int SMEM_LIMIT = 227 * 1024;

// staged record of one match for row camera a: 4 streams (J0, J1, Z0, Z1)
// at a and at the other camera, the eA and yeb segments at a, the other
// camera's id (-1: none)
constexpr int J0A = 0, J1A = 6, Z0A = 12, Z1A = 18;
constexpr int J0O = 24, J1O = 30, Z0O = 36, Z1O = 42;
constexpr int EAS = 48, YBS = 54, OTHER = 60, REC = 61;

struct Plan {
  int tiles, slices, tiles_per_slice, groups, smem;
  long long row_block;   // floats of one camera's partial: 72N + 12
};

int make_plan(int M, int N, Plan* P) {
  if (M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  P->row_block = 72LL * N + 12;
  P->tiles = (M + TILE - 1) / TILE;
  int want = (TARGET_CTAS + N - 1) / N;
  P->slices = want < P->tiles ? want : P->tiles;
  P->tiles_per_slice = (P->tiles + P->slices - 1) / P->slices;
  P->slices = (P->tiles + P->tiles_per_slice - 1) / P->tiles_per_slice;
  long long fixed = (long long)TILE * REC * 4 + TILE * 4 + WARPS * 4;
  long long g = (SMEM_LIMIT - fixed) / (P->row_block * 4);
  if (g < 1) return (int)cudaErrorInvalidValue;   // N too large
  P->groups = g < MAX_GROUPS ? (int)g : MAX_GROUPS;
  P->smem = (int)(fixed + P->groups * P->row_block * 4);
  return 0;
}

// the segments of match m at row camera a (and at its other camera)
__device__ void stage(float* R, int m, int a, int N, const float* ai,
                      const float* aj, const float* bp, const float* r2,
                      const float* l00, const float* l10, const float* l11,
                      const float* g0, const float* g1, const int* mi,
                      const int* mj, bool schur) {
  const int ci = mi[m], cj = mj[m];
  const bool ia = ci == a, ja = cj == a;
  int other = -1;
  const float* so = nullptr;   // the other camera's Jacobian rows
  if (ia && !ja && cj >= 0 && cj < N) {
    other = cj;
    so = aj + (long)m * 12;
  } else if (ja && !ia && ci >= 0 && ci < N) {
    other = ci;
    so = ai + (long)m * 12;
  }
  R[OTHER] = __int_as_float(other);
  const float* pa = ai + (long)m * 12;
  const float* pj = aj + (long)m * 12;
  const float b00 = bp[m * 4 + 0], b01 = bp[m * 4 + 1];
  const float b10 = bp[m * 4 + 2], b11 = bp[m * 4 + 3];
  const float r20 = r2[m * 2 + 0], r21 = r2[m * 2 + 1];
  const float L00 = l00[m], L10 = l10[m], L11 = l11[m];
  const float G0 = g0[m], G1 = g1[m];
  for (int k = 0; k < 6; ++k) {
    // the masked sum of the plain version: 1*x + 0*y is x exactly
    const float j0 = (ia ? pa[k] : 0.0f) + (ja ? pj[k] : 0.0f);
    const float j1 = (ia ? pa[6 + k] : 0.0f) + (ja ? pj[6 + k] : 0.0f);
    R[J0A + k] = j0;
    R[J1A + k] = j1;
    R[EAS + k] = j0 * r20 + j1 * r21;
    const float o0 = so ? so[k] : 0.0f;
    const float o1 = so ? so[6 + k] : 0.0f;
    R[J0O + k] = o0;
    R[J1O + k] = o1;
    if (schur) {
      const float w0 = j0 * b00 + j1 * b10;
      const float w1 = j0 * b01 + j1 * b11;
      R[Z0A + k] = w0 * L00 + w1 * L10;
      R[Z1A + k] = w1 * L11;
      R[YBS + k] = w0 * G0 + w1 * G1;
      const float v0 = o0 * b00 + o1 * b10;
      const float v1 = o0 * b01 + o1 * b11;
      R[Z0O + k] = v0 * L00 + v1 * L10;
      R[Z1O + k] = v1 * L11;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
partial_kernel(const float* __restrict__ ai, const float* __restrict__ aj,
               const float* __restrict__ bp, const float* __restrict__ r2,
               const float* __restrict__ l00, const float* __restrict__ l10,
               const float* __restrict__ l11, const float* __restrict__ g0,
               const float* __restrict__ g1, const int* __restrict__ mi,
               const int* __restrict__ mj, float* __restrict__ part, int M,
               int N, int tiles, int tiles_per_slice, int groups,
               int schur) {
  extern __shared__ float smem[];
  const long long PW = 72LL * N + 12;
  float* rec = smem;                                   // TILE * REC
  float* acc = rec + TILE * REC;                       // groups * PW
  int* list = (int*)(acc + groups * PW);               // TILE
  int* wcount = list + TILE;                           // WARPS
  const int a = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int sN = 6 * N;

  for (long long i = tid; i < groups * PW; i += THREADS) acc[i] = 0.0f;

  const int g = tid / 36, pq = tid % 36, p = pq / 6, q = pq % 6;
  const bool worker = g < groups;
  float* mine = acc + (worker ? g : 0) * PW;
  float u_aa = 0.0f, yw_aa = 0.0f, ea = 0.0f, yb = 0.0f;
  __syncthreads();

  const int t1 = min(tiles, (s + 1) * tiles_per_slice);
  for (int t = s * tiles_per_slice; t < t1; ++t) {
    const int m = t * TILE + tid;
    bool touch = false;
    if (m < M) touch = mi[m] == a || mj[m] == a;
    const unsigned ballot = __ballot_sync(0xffffffffu, touch);
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, total = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int c = wcount[w];
      base += w < warp ? c : 0;
      total += c;
    }
    if (touch) list[base + __popc(ballot & ((1u << lane) - 1u))] = m;
    __syncthreads();
    if (tid < total)
      stage(rec + tid * REC, list[tid], a, N, ai, aj, bp, r2, l00, l10, l11,
            g0, g1, mi, mj, schur != 0);
    __syncthreads();
    if (worker) {
      for (int e = g; e < total; e += groups) {
        const float* R = rec + e * REC;
        u_aa += R[J0A + p] * R[J0A + q] + R[J1A + p] * R[J1A + q];
        if (schur)
          yw_aa += R[Z0A + p] * R[Z0A + q] + R[Z1A + p] * R[Z1A + q];
        if (q == 0) {
          ea += R[EAS + p];
          if (schur) yb += R[YBS + p];
        }
        const int o = __float_as_int(R[OTHER]);
        if (o >= 0) {
          const long long col = (long long)p * sN + o * 6 + q;
          mine[col] += R[J0A + p] * R[J0O + q] + R[J1A + p] * R[J1O + q];
          if (schur)
            mine[36LL * N + col] +=
                R[Z0A + p] * R[Z0O + q] + R[Z1A + p] * R[Z1O + q];
        }
      }
    }
    __syncthreads();   // the next tile overwrites wcount, list and rec
  }

  if (worker) {
    // column a of the row block gets no off-diagonal term (o != a)
    const long long col = (long long)p * sN + a * 6 + q;
    mine[col] = u_aa;
    mine[36LL * N + col] = yw_aa;
    if (q == 0) {
      mine[72LL * N + p] = ea;
      mine[72LL * N + 6 + p] = yb;
    }
  }
  __syncthreads();
  float* out = part + ((long long)s * N + a) * PW;
  for (long long i = tid; i < PW; i += THREADS) {
    float v = 0.0f;
    for (int k = 0; k < groups; ++k) v += acc[k * PW + i];
    out[i] = v;
  }
}

__global__ void reduce_kernel(const float* __restrict__ part,
                              float* __restrict__ U, float* __restrict__ eA,
                              float* __restrict__ YW,
                              float* __restrict__ yeb, int N, int slices,
                              int schur) {
  const long long PW = 72LL * N + 12;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N * PW) return;
  const int a = (int)(idx / PW);
  const long long i = idx % PW;
  float v = 0.0f;
  for (int s = 0; s < slices; ++s) v += part[((long long)s * N + a) * PW + i];
  const long long sN = 6LL * N, U_len = 36LL * N;
  if (i < U_len) {
    U[(a * 6 + i / sN) * sN + i % sN] = v;
  } else if (i < 2 * U_len) {
    const long long j = i - U_len;
    YW[(a * 6 + j / sN) * sN + j % sN] = schur ? v : 0.0f;
  } else if (i < 2 * U_len + 6) {
    eA[a * 6 + (i - 2 * U_len)] = v;
  } else {
    yeb[a * 6 + (i - 2 * U_len - 6)] = schur ? v : 0.0f;
  }
}

}  // namespace

extern "C" {

// Floats of device scratch spt_ba_assemble needs for M matches and N
// cameras, in *floats; returns a cudaError_t code (0 on success).
int spt_ba_assemble_scratch(int M, int N, long long* floats) {
  Plan P;
  int err = make_plan(M, N, &P);
  if (err) return err;
  *floats = (long long)P.slices * N * P.row_block;
  return 0;
}

// Accumulate U (6N, 6N), eA (6N,), YW (6N, 6N) and yeb (6N,) from the
// per-match streams, all float32 row-major on the device: ai, aj
// (M, 2, 6), bp (M, 2, 2), r2 (M, 2), l00, l10, l11, g0, g1 (M,); camera
// ids mi, mj int32 (M,). `part` is caller-allocated scratch of
// spt_ba_assemble_scratch floats. Runs on `stream` (two launches); returns
// a cudaError_t code (0 on success).
int spt_ba_assemble(const float* ai, const float* aj, const float* bp,
                    const float* r2, const float* l00, const float* l10,
                    const float* l11, const float* g0, const float* g1,
                    const int* mi, const int* mj, float* U, float* eA,
                    float* YW, float* yeb, float* part, int M, int N,
                    int with_schur, void* stream) {
  Plan P;
  int err = make_plan(M, N, &P);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t ce = cudaFuncSetAttribute(
      partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
  if (ce != cudaSuccess) return (int)ce;
  partial_kernel<<<dim3(N, P.slices), THREADS, P.smem, st>>>(
      ai, aj, bp, r2, l00, l10, l11, g0, g1, mi, mj, part, M, N, P.tiles,
      P.tiles_per_slice, P.groups, with_schur);
  if ((ce = cudaGetLastError()) != cudaSuccess) return (int)ce;
  const long long n_out = (long long)N * P.row_block;
  reduce_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, st>>>(
      part, U, eA, YW, yeb, N, P.slices, with_schur);
  return (int)cudaGetLastError();
}

const char* spt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
