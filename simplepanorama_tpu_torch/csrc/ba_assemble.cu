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
// Where it runs. The bundle adjustment calls it once per LM trial, inside
// a CUDA graph, at N = 8 or 16 camera slots and M = 2,048-8,192 matches on
// the stitches the port is measured on (N = 40, M = 20,480 stays
// supported). In a single-card trial its neighbours in the graph are
// csrc/ba_trial.cu's kernels: kernel 4 (trial_streams_kernel) writes the
// streams it reads, kernel 5 (solve_accept_kernel) reads its sums; in
// the sharded trial, PyTorch's operations of ba.lm_step and an
// all-reduce of its sums. Bound on this card: a match reads 37 four-byte
// values (148 B) and does ~1 kFLOP, so M = 8,192 reads 1.2 MB (0.36 us of HBM
// time) against 0.1 us of f32 arithmetic: memory-bound on paper, latency-
// bound in practice. The TPU kernel built dense (512, 6N) J / W / Z tiles
// and carried the sums in VMEM across a sequential grid; a match touches
// only three 6x6 blocks of each matrix ((mi, mi), (mj, mj) and the pair
// block), so nothing dense is built here.
//
// Design: one cooperative launch, each match's streams read once, sums
// deterministic (fixed-order partials, no float atomics).
//  * CTA c owns a contiguous slice of the matches. It stages a round of
//    matches in shared memory (one thread per match: both cameras' J
//    rows, Z rows, eA and yeb segments), then 216 threads accumulate:
//    role 0 the diagonal block of the first camera, role 1 that of the
//    second, role 2 the pair block (lower id, higher id); within a role,
//    thread (U or YW, p, q) is the only writer of entry (p, q) of every
//    block, so there are no races. A thread sums a run of matches of the
//    same block in registers and adds the run to shared memory when the
//    block changes: the bundle adjustment's matches come sorted by camera
//    pair, so runs are long.
//  * The CTA writes the blocks it touched as its partial (84 floats a
//    block: U, YW, eA, yeb) and a touched flag for every block.
//  * Grid barrier; then one warp per block sums the partials of the CTAs
//    that touched it: the flags of all CTAs come in one load round, and
//    lane l adds entries l, l + 32, l + 64 over those CTAs in CTA order,
//    with eight CTAs' loads in flight at a time (one L2 round trip per
//    entry made this phase ~40 us, most of the kernel). The order
//    depends on the inputs only, so two calls give the same bits.
//  * Pair blocks (6x6 above the diagonal) go to both triangles of U / YW.
// Each multiply and add of a segment is the plain version's own
// (ops/ba_kernel.py::assemble_streams_ref, built with -fmad=false); the
// sums run in another order, so the outputs agree within
// 1e-3 * max|plain| + 1e-4, the TPU kernel's own test bound.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNITS = 216;          // 3 roles x (U, YW) x 36 entries
constexpr int STAGE = 128;          // matches staged per round
constexpr int MAX_CTAS = 128;       // 4 CTAs a lane in the final sums
constexpr int MIN_PER_CTA = 64;
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int BLK = 84;             // partial of a block: U 36, YW 36, eA 6, yeb 6
constexpr int OFF = 72;             // pair block in shared memory: U 36, YW 36

// staged record of one match: per side (the first camera, then the
// second) J0, J1, Z0, Z1, eA and yeb segments; then the two camera ids
// (-1: none). Odd stride: one bank per staging thread.
constexpr int J0 = 0, J1 = 6, Z0 = 12, Z1 = 18, EA = 24, YB = 30;
constexpr int SIDE = 36, CX = 72, CY = 73, REC = 75;

struct Plan {
  int ctas, per_cta, off_in_smem, n_blocks;
  int smem;
  long long part_floats, flag_bytes;
};

__host__ __device__ inline int n_pairs(int N) { return N * (N - 1) / 2; }

// index of the pair block (lo, hi), lo < hi, in row-major upper order
__device__ inline int pair_index(int lo, int hi, int N) {
  return lo * (2 * N - lo - 1) / 2 + (hi - lo - 1);
}

long long smem_bytes(int N, bool off_in_smem) {
  long long b = (long long)STAGE * REC * 4 + 2LL * N * BLK * 4 +
                (2LL * N + n_pairs(N) + 15) / 16 * 16;
  if (off_in_smem) b += (long long)n_pairs(N) * OFF * 4;
  return b;
}

int make_plan(int M, int N, Plan* P);

// stage match m: both sides' segments, as the plain version forms them
__device__ void stage(float* R, int m, int N, const float* __restrict__ ai,
                      const float* __restrict__ aj,
                      const float* __restrict__ bp,
                      const float* __restrict__ r2,
                      const float* __restrict__ l00,
                      const float* __restrict__ l10,
                      const float* __restrict__ l11,
                      const float* __restrict__ g0,
                      const float* __restrict__ g1,
                      const int* __restrict__ mi, const int* __restrict__ mj,
                      bool schur) {
  const int ci = mi[m], cj = mj[m];
  const bool iin = ci >= 0 && ci < N, jin = cj >= 0 && cj < N;
  const bool same = iin && jin && ci == cj;
  float a[12], b[12];
  const float4* pa = reinterpret_cast<const float4*>(ai + (long long)m * 12);
  const float4* pb = reinterpret_cast<const float4*>(aj + (long long)m * 12);
  for (int k = 0; k < 3; ++k) {
    const float4 x = pa[k], y = pb[k];
    a[4 * k] = x.x; a[4 * k + 1] = x.y; a[4 * k + 2] = x.z; a[4 * k + 3] = x.w;
    b[4 * k] = y.x; b[4 * k + 1] = y.y; b[4 * k + 2] = y.z; b[4 * k + 3] = y.w;
  }
  const float4 B = reinterpret_cast<const float4*>(bp)[m];  // b00 b01 b10 b11
  const float2 r = reinterpret_cast<const float2*>(r2)[m];
  const float L00 = l00[m], L10 = l10[m], L11 = l11[m], G0 = g0[m], G1 = g1[m];
  // side 0: camera mi (with aj's rows too when mj == mi); side 1: mj
  const int cam[2] = {iin ? ci : -1, (jin && !same) ? cj : -1};
  R[CX] = __int_as_float(cam[0]);
  R[CY] = __int_as_float(cam[1]);
  for (int s = 0; s < 2; ++s) {
    if (cam[s] < 0) continue;
    float* S = R + s * SIDE;
    for (int k = 0; k < 6; ++k) {
      // the masked sum of the plain version: 1*x + 1*y, or x alone
      const float j0 = s == 0 ? (same ? a[k] + b[k] : a[k]) : b[k];
      const float j1 = s == 0 ? (same ? a[6 + k] + b[6 + k] : a[6 + k])
                              : b[6 + k];
      S[J0 + k] = j0;
      S[J1 + k] = j1;
      S[EA + k] = j0 * r.x + j1 * r.y;
      if (schur) {
        const float w0 = j0 * B.x + j1 * B.z;
        const float w1 = j0 * B.y + j1 * B.w;
        S[Z0 + k] = w0 * L00 + w1 * L10;
        S[Z1 + k] = w1 * L11;
        S[YB + k] = w0 * G0 + w1 * G1;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
assemble_kernel(const float* __restrict__ ai, const float* __restrict__ aj,
                const float* __restrict__ bp, const float* __restrict__ r2,
                const float* __restrict__ l00, const float* __restrict__ l10,
                const float* __restrict__ l11, const float* __restrict__ g0,
                const float* __restrict__ g1, const int* __restrict__ mi,
                const int* __restrict__ mj, float* __restrict__ U,
                float* __restrict__ eA, float* __restrict__ YW,
                float* __restrict__ yeb, float* __restrict__ part,
                unsigned char* __restrict__ flags, int M, int N,
                int per_cta, int off_in_smem, int schur) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int c = blockIdx.x, S = gridDim.x, tid = threadIdx.x;
  const int np = n_pairs(N), nb = N + np;
  float* rec = smem;                                   // STAGE * REC
  float* diag = rec + STAGE * REC;                     // 2 * N * BLK
  unsigned char* touched = reinterpret_cast<unsigned char*>(
      diag + 2 * N * BLK);                             // 2N + np bytes
  float* off_s = reinterpret_cast<float*>(
      touched + (2 * N + np + 15) / 16 * 16);          // np * OFF
  float* mine = part + (long long)c * nb * BLK;        // this CTA's partial
  // the pair blocks accumulate in shared memory, or (large N) in this
  // CTA's partial in device memory
  float* off = off_in_smem ? off_s : mine + (long long)N * BLK;
  const int off_stride = off_in_smem ? OFF : BLK;

  for (int i = tid; i < 2 * N * BLK; i += THREADS) diag[i] = 0.0f;
  for (int i = tid; i < 2 * N + np; i += THREADS) touched[i] = 0;
  for (long long i = tid; i < (long long)np * off_stride; i += THREADS)
    off[i] = 0.0f;
  __syncthreads();

  const int role = tid / 72, mat = (tid / 36) % 2, pq = tid % 36;
  const int p = pq / 6, q = pq % 6;
  const bool active = tid < UNITS && (schur || mat == 0);
  const int seg = mat == 0 ? J0 : Z0, seg1 = mat == 0 ? J1 : Z1;
  const int vec = mat == 0 ? EA : YB;
  float* dmine = diag + (role == 1 ? N * BLK : 0);
  int cur = -1;            // block of the run in registers
  float acc = 0.0f, acc_v = 0.0f;

  const int m0 = c * per_cta;
  const int m1 = min(M, m0 + per_cta);
  for (int base = m0; base < m1; base += STAGE) {
    const int count = min(STAGE, m1 - base);
    if (tid < count)
      stage(rec + tid * REC, base + tid, N, ai, aj, bp, r2, l00, l10, l11,
            g0, g1, mi, mj, schur != 0);
    __syncthreads();
    if (active) {
      for (int e = 0; e < count; ++e) {
        const float* R = rec + e * REC;
        const int cx = __float_as_int(R[CX]), cy = __float_as_int(R[CY]);
        int blk;
        float v, w = 0.0f;
        if (role < 2) {
          blk = role == 0 ? cx : cy;
          if (blk < 0) continue;
          const float* Sd = R + role * SIDE;
          v = Sd[seg + p] * Sd[seg + q] + Sd[seg1 + p] * Sd[seg1 + q];
          w = Sd[vec + p];
        } else {
          if (cx < 0 || cy < 0) continue;
          const float* lo = R + (cx < cy ? 0 : SIDE);
          const float* hi = R + (cx < cy ? SIDE : 0);
          blk = pair_index(min(cx, cy), max(cx, cy), N);
          v = lo[seg + p] * hi[seg + q] + lo[seg1 + p] * hi[seg1 + q];
        }
        if (blk != cur) {
          if (cur >= 0) {
            if (role < 2) {
              dmine[cur * BLK + mat * 36 + pq] += acc;
              if (q == 0) dmine[cur * BLK + 72 + mat * 6 + p] += acc_v;
            } else {
              off[(long long)cur * off_stride + mat * 36 + pq] += acc;
            }
          }
          cur = blk;
          acc = acc_v = 0.0f;
          if (pq == 0 && mat == 0)
            touched[role == 2 ? 2 * N + blk : role * N + blk] = 1;
        }
        acc += v;
        acc_v += w;
      }
    }
    __syncthreads();   // the next round overwrites the records
  }
  if (active && cur >= 0) {
    if (role < 2) {
      dmine[cur * BLK + mat * 36 + pq] += acc;
      if (q == 0) dmine[cur * BLK + 72 + mat * 6 + p] += acc_v;
    } else {
      off[(long long)cur * off_stride + mat * 36 + pq] += acc;
    }
  }
  __syncthreads();

  // this CTA's partial: the blocks it touched, and a flag for every block
  unsigned char* fl = flags + (long long)c * nb;
  for (int a = tid; a < N; a += THREADS) fl[a] = touched[a] | touched[N + a];
  for (int k = tid; k < np; k += THREADS) fl[N + k] = touched[2 * N + k];
  for (int i = tid; i < N * BLK; i += THREADS) {
    const int a = i / BLK;
    if (touched[a] | touched[N + a]) mine[i] = diag[i] + diag[N * BLK + i];
  }
  if (off_in_smem) {
    for (int i = tid; i < np * OFF; i += THREADS) {
      const int k = i / OFF;
      if (touched[2 * N + k])
        mine[(long long)(N + k) * BLK + i % OFF] = off_s[i];
    }
  }
  __threadfence();
  grid.sync();

  // one warp per block: the touched flags of all CTAs in one load round
  // (a ballot per 32 CTAs), then lane l sums entries l, l + 32, l + 64
  // over the CTAs that touched the block, in CTA order, eight CTAs'
  // loads in flight at a time
  const int lane = tid & 31;
  const int sN = 6 * N;
  for (int b = c * WARPS + tid / 32; b < nb; b += S * WARPS) {
    unsigned bits[MAX_CTAS / 32];
#pragma unroll
    for (int k = 0; k < MAX_CTAS / 32; ++k) {
      const int cc = lane + 32 * k;
      bits[k] = __ballot_sync(
          0xffffffffu, cc < S && __ldcg(flags + (long long)cc * nb + b));
    }
    int lo = b, hi = b;   // diagonal block b < N, or pair block (lo, hi)
    if (b >= N) {
      int k = b - N;
      lo = 0;
      while (k >= N - 1 - lo) {
        k -= N - 1 - lo;
        ++lo;
      }
      hi = lo + 1 + k;
    }
    const int n_e = b < N ? BLK : OFF;
    float v[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < MAX_CTAS / 32; ++k) {
      unsigned w = bits[k];
      while (w) {
        int cc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          cc[i] = w ? 32 * k + __ffs(w) - 1 : -1;
          w &= w - 1u;
        }
        float x[8][3];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float* src =
              part + ((long long)(cc[i] < 0 ? 0 : cc[i]) * nb + b) * BLK;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int e = lane + 32 * j;
            x[i][j] = (cc[i] >= 0 && e < n_e) ? __ldcg(src + e) : 0.0f;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) v[j] += x[i][j];
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int e = lane + 32 * j;
      if (e >= n_e) continue;
      float val = v[j];
      if (e >= 72) {
        const int i = lo * 6 + (e - 72) % 6;
        if (e < 78) eA[i] = val;
        else yeb[i] = schur ? val : 0.0f;
        continue;
      }
      float* out = e < 36 ? U : YW;
      if (e >= 36 && !schur) val = 0.0f;
      const int pp = (e % 36) / 6, qq = e % 6;
      out[(long long)(lo * 6 + pp) * sN + hi * 6 + qq] = val;
      if (lo != hi) out[(long long)(hi * 6 + qq) * sN + lo * 6 + pp] = val;
    }
  }
}

int make_plan(int M, int N, Plan* P) {
  if (M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  P->n_blocks = N + n_pairs(N);
  P->off_in_smem = smem_bytes(N, true) <= SMEM_LIMIT;
  const long long smem = smem_bytes(N, P->off_in_smem != 0);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;   // N too large
  P->smem = (int)smem;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce == cudaSuccess)
    ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, assemble_kernel, THREADS, P->smem);
  if (ce != cudaSuccess) return (int)ce;
  int cap = sms * per_sm;   // CTAs resident at once: the grid barrier's limit
  if (cap > MAX_CTAS) cap = MAX_CTAS;
  if (cap < 1) return (int)cudaErrorInvalidConfiguration;
  int per = (M + cap - 1) / cap;
  if (per < MIN_PER_CTA) per = MIN_PER_CTA;
  P->per_cta = per;
  P->ctas = (M + per - 1) / per;
  P->part_floats = (long long)P->ctas * P->n_blocks * BLK;
  P->flag_bytes = (long long)P->ctas * P->n_blocks;
  return 0;
}

}  // namespace

extern "C" {

// Once per process, before the first launch: lets the kernel use the
// shared memory its plans ask for. Returns a cudaError_t code.
int spt_ba_assemble_init() {
  return (int)cudaFuncSetAttribute(
      assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT);
}

// The launch plan for M matches and N cameras on the current device, in
// plan[0..5]: CTAs, matches per CTA, pair blocks in shared memory (0/1),
// shared-memory bytes, floats of partial scratch, bytes of flag scratch.
// Returns a cudaError_t code (0 on success).
int spt_ba_assemble_plan(int M, int N, long long* plan) {
  Plan P;
  const int err = make_plan(M, N, &P);
  if (err) return err;
  plan[0] = P.ctas;
  plan[1] = P.per_cta;
  plan[2] = P.off_in_smem;
  plan[3] = P.smem;
  plan[4] = P.part_floats;
  plan[5] = P.flag_bytes;
  return 0;
}

// Accumulate U (6N, 6N), eA (6N,), YW (6N, 6N) and yeb (6N,) from the
// per-match streams, all float32 row-major on the device: ai, aj
// (M, 2, 6), bp (M, 2, 2), r2 (M, 2), l00, l10, l11, g0, g1 (M,); camera
// ids mi, mj int32 (M,). `part` and `flags` are caller-allocated scratch
// of the plan's sizes (no initial value needed; one launch at a time may
// use them); ctas, per_cta, off_in_smem and smem come from the plan. One
// cooperative launch on `stream`; returns a cudaError_t code.
int spt_ba_assemble(const float* ai, const float* aj, const float* bp,
                    const float* r2, const float* l00, const float* l10,
                    const float* l11, const float* g0, const float* g1,
                    const int* mi, const int* mj, float* U, float* eA,
                    float* YW, float* yeb, float* part, unsigned char* flags,
                    int M, int N, int with_schur, int ctas, int per_cta,
                    int off_in_smem, int smem, void* stream) {
  void* args[] = {(void*)&ai,  (void*)&aj,   (void*)&bp,  (void*)&r2,
                  (void*)&l00, (void*)&l10,  (void*)&l11, (void*)&g0,
                  (void*)&g1,  (void*)&mi,   (void*)&mj,  (void*)&U,
                  (void*)&eA,  (void*)&YW,   (void*)&yeb, (void*)&part,
                  (void*)&flags, (void*)&M,  (void*)&N,   (void*)&per_cta,
                  (void*)&off_in_smem, (void*)&with_schur};
  cudaError_t ce = cudaLaunchCooperativeKernel(
      (const void*)assemble_kernel, dim3(ctas), dim3(THREADS), args,
      (size_t)smem, (cudaStream_t)stream);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

const char* spt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
