// The global-relabel BFS of both min-cut kernels (csrc/mincut.cu and
// csrc/mincut_tiled.cu): exact distances to the nearest sink through
// positive residual edges, worked one tile at a time by one CTA in shared
// memory.
//
// A tile is BH rows of NWB 32-bit words (BW = 32 * NWB columns); bit i of
// word c of row r is the cell (r, 32c + i). Five bitplanes of the tile
// hold the cells that can step right, left, down and up (residual capacity
// toward that neighbour > 0, which implies that both cells are nodes) and
// the sinks. A warp works a 32 x 32-cell sub-tile with one word per lane:
// one BFS level is a few shifts, ANDs and ORs of the frontier words (the
// rows above and below come by shuffle), a look at the distance of each
// candidate, and a warp vote; no block barrier.
//
// The cells around the tile (its halo) carry fixed distances from outside
// it. A halo cell at distance D is a seed that enters the frontier at level
// D: an interior cell that can step into it is reached at level D + 1
// unless the BFS reached it earlier. Sinks inside the tile enter at level
// 0. A cell's distance is the level at which it is first reached, so the
// tile's distances are exact for the halo distances it was given. Levels
// at which the frontier is empty are skipped: the next level is then the
// least halo distance that can still reach an unvisited cell.
//
// A tile keeps its distances between rounds and propagates only what
// changed: the sinks in its first round, then the halo cells whose
// distance dropped. Rounds over all tiles until no distance on a tile's
// edge drops give the exact distances of the whole grid. Every value a
// tile reads is the length of a real path and distances only decrease, so
// a round in which no edge changed saw a constant halo everywhere, whose
// tile-local fixpoints form a global one; a fixpoint of d(p) = min(seed,
// 1 + min d(q)) in which every value is the length of a real path is the
// shortest one.

#pragma once

#include <stdint.h>

namespace spt {

constexpr int INF_I = 0x3fffffff;   // "no path" as an int distance
constexpr float INF_F = 1e18f;      // "no path" as a float height
constexpr unsigned FULL = 0xffffffffu;

// direction order: 0=right(+x), 1=left(-x), 2=down(+y), 3=up(-y)
__host__ __device__ __forceinline__ int dir_dy(int k) { return k == 2 ? 1 : (k == 3 ? -1 : 0); }
__host__ __device__ __forceinline__ int dir_dx(int k) { return k == 0 ? 1 : (k == 1 ? -1 : 0); }

__device__ __forceinline__ int height_to_int(float h) {
  return h < INF_F ? (int)h : INF_I;
}

// Shared-memory layout of one BFS tile (all uint32 / int, carved by the
// caller from dynamic shared memory with bfs_smem_words).
struct BfsTile {
  int BH, NWB;           // rows, words per row
  uint32_t* op[4];       // [BH * NWB] may step toward neighbour k
  uint32_t* sink;        // [BH * NWB] sinks (seeds at level 0)
  uint32_t* drop[2];     // [BH * NWB] lowered in a block round, by parity
  int* halo[4];          // top [BW], bottom [BW], left [BH], right [BH]
  int* halo_old;         // [2 BW + 2 BH] the halo of the tile's last round
};

__host__ __device__ __forceinline__ int bfs_smem_words(int BH, int NWB) {
  int nw = BH * NWB, BW = 32 * NWB;
  return 7 * nw + 2 * (2 * BW + 2 * BH);
}

__device__ __forceinline__ BfsTile bfs_carve(uint32_t* base, int BH, int NWB) {
  BfsTile T;
  int nw = BH * NWB, BW = 32 * NWB;
  T.BH = BH;
  T.NWB = NWB;
#pragma unroll
  for (int k = 0; k < 4; ++k) T.op[k] = base + k * nw;
  T.sink = base + 4 * nw;
  T.drop[0] = base + 5 * nw;
  T.drop[1] = base + 6 * nw;
  int* hb = reinterpret_cast<int*>(base + 7 * nw);
  T.halo[0] = hb;
  T.halo[1] = hb + BW;
  T.halo[2] = hb + 2 * BW;
  T.halo[3] = hb + 2 * BW + BH;
  T.halo_old = hb + 2 * BW + 2 * BH;
  return T;
}

// Before a tile's first BFS round: no halo distance seen yet.
__device__ __forceinline__ void bfs_forget_halo(const BfsTile& T) {
  const int n = 2 * 32 * T.NWB + 2 * T.BH;
  for (int i = threadIdx.x; i < n; i += blockDim.x) T.halo_old[i] = INF_I;
}

// halo cell i of the flat halo order (top, bottom, left, right): its new
// distance if it dropped since the tile's last round, else INF_I
__device__ __forceinline__ int bfs_seed_at(const BfsTile& T, int i) {
  int d = T.halo[0][i];   // the four arrays are contiguous
  return d < T.halo_old[i] ? d : INF_I;
}

// One BFS round of one tile, incremental. The tile's current distances
// are kept by the caller (get(r, x) / set(r, x, d)); they are exact for
// the halo the tile saw last round, so only what changed since is
// propagated: in the first round (`first`) the sinks, which enter at level
// 0, and in every round the halo cells whose distance dropped, each at its
// new distance.
//
// Inside the tile the same scheme runs one level down. Each warp owns
// 32 x 32-cell sub-tiles, one lane per row and one word per lane, and runs
// their levels with shuffles and warp votes only: a level lowers every
// cell next to the frontier (and able to step into it) whose distance is
// above the level + 1, and those cells are the next frontier; a cell
// looked at and not lowered cannot be lowered at a later level. A sub-
// tile's seeds are the sinks (first round), the tile's halo cells that
// dropped (first block round) and the cells of the neighbouring sub-tiles
// that dropped in the block round before; block rounds, one barrier each,
// run until no sub-tile's edge dropped. On entry op, sink and halo are
// filled and a barrier has passed; blockDim.x is a multiple of 32. Lane 0
// of each warp adds the levels it ran to *levels when given. Returns,
// block-uniform, whether a distance on the tile's edge dropped (the only
// ones other tiles read).
template <class Get, class Set>
__device__ __forceinline__ bool bfs_tile(const BfsTile& T, bool first, Get get, Set set,
                         int* levels = nullptr) {
  const int NWB = T.NWB, BH = T.BH, BW = 32 * NWB, nw = BH * NWB;
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int n_sub = (BH + 31) / 32 * NWB;
  bool tile_edge_drop = false;
  for (int i = threadIdx.x; i < 2 * nw; i += blockDim.x)
    (i < nw ? T.drop[0] : T.drop[1])[i % nw] = 0u;
  __syncthreads();
  for (int kb = 0;; ++kb) {
    uint32_t* dnow = (kb & 1) ? T.drop[1] : T.drop[0];
    const uint32_t* dprev = (kb & 1) ? T.drop[0] : T.drop[1];
    bool sub_edge_drop = false;
    for (int sb = threadIdx.x >> 5; sb < n_sub; sb += nwarps) {
      const int c = sb % NWB, r0 = 32 * (sb / NWB);
      const int nrows = min(32, BH - r0);
      const int r = r0 + lane, w = r * NWB + c, x0 = 32 * c;
      const bool row_in = lane < nrows;
      const uint32_t op0 = row_in ? T.op[0][w] : 0u;
      const uint32_t op1 = row_in ? T.op[1][w] : 0u;
      const uint32_t op2 = row_in ? T.op[2][w] : 0u;
      const uint32_t op3 = row_in ? T.op[3][w] : 0u;
      // the distance a neighbour cell (y, x) of the sub-tile enters at,
      // or INF_I when it is no seed this block round
      auto seed = [&](int y, int x) -> int {
        if (y < 0) return kb == 0 ? bfs_seed_at(T, x) : INF_I;
        if (y >= BH) return kb == 0 ? bfs_seed_at(T, BW + x) : INF_I;
        if (x < 0) return kb == 0 ? bfs_seed_at(T, 2 * BW + y) : INF_I;
        if (x >= BW) return kb == 0 ? bfs_seed_at(T, 2 * BW + BH + y) : INF_I;
        return ((dprev[y * NWB + (x >> 5)] >> (x & 31)) & 1u) ? get(y, x)
                                                              : INF_I;
      };
      // seeds above and below (lane = column), left and right (lane =
      // row), kept only where the cell next to them can step into them
      const uint32_t top_op = __shfl_sync(FULL, op3, 0);
      const uint32_t bot_op = __shfl_sync(FULL, op2, nrows - 1);
      const int s_top = ((top_op >> lane) & 1u) ? seed(r0 - 1, x0 + lane)
                                                : INF_I;
      const int s_bot = ((bot_op >> lane) & 1u) ? seed(r0 + nrows, x0 + lane)
                                                : INF_I;
      const int s_lft = (op1 & 1u) ? seed(r, x0 - 1) : INF_I;
      const int s_rgt = (op0 >> 31) ? seed(r, x0 + 32) : INF_I;
      auto next_seed = [&](int L) {
        int m = INF_I;
        if (s_top > L) m = min(m, s_top);
        if (s_bot > L) m = min(m, s_bot);
        if (s_lft > L) m = min(m, s_lft);
        if (s_rgt > L) m = min(m, s_rgt);
        return __reduce_min_sync(FULL, m);
      };
      uint32_t F = (first && kb == 0 && row_in) ? T.sink[w] : 0u;
      uint32_t seen = F, dropped = F;   // sinks count as dropped at once
      int L = __any_sync(FULL, F != 0u) ? 0 : next_seed(-1);
      int lv = 0;
      while (L < INF_I) {
        const uint32_t tm = __ballot_sync(FULL, s_top == L);
        const uint32_t bm = __ballot_sync(FULL, s_bot == L);
        uint32_t up = __shfl_up_sync(FULL, F, 1);
        uint32_t dn = __shfl_down_sync(FULL, F, 1);
        if (lane == 0) up = tm;
        if (lane == nrows - 1) dn = bm;
        const uint32_t lf = (F << 1) | (s_lft == L ? 1u : 0u);
        const uint32_t rt = (F >> 1) | (s_rgt == L ? 0x80000000u : 0u);
        uint32_t cand = ((op0 & rt) | (op1 & lf) | (op2 & dn) | (op3 & up)) &
                        ~seen;
        seen |= cand;
        // a lane looks at its few candidates itself; the warp takes the
        // words with many, one lane per cell, so a full word costs one
        // pass and not 32
        uint32_t nv = 0;
        const bool dense = __popc(cand) > 4;
        for (uint32_t few = dense ? 0u : cand; few; few &= few - 1) {
          const int b = __ffs(few) - 1;
          if (get(r, x0 + b) > L + 1) {
            set(r, x0 + b, L + 1);
            nv |= 1u << b;
          }
        }
        for (uint32_t todo = __ballot_sync(FULL, dense); todo;
             todo &= todo - 1) {
          const int src = __ffs(todo) - 1;
          const uint32_t cw = __shfl_sync(FULL, cand, src);
          const bool low = ((cw >> lane) & 1u) &&
                           get(r0 + src, x0 + lane) > L + 1;
          if (low) set(r0 + src, x0 + lane, L + 1);
          const uint32_t got = __ballot_sync(FULL, low);
          if (lane == src) nv = got;
        }
        F = nv;
        dropped |= nv;
        ++lv;
        L = __any_sync(FULL, F != 0u) ? L + 1 : next_seed(L);
      }
      if (row_in) dnow[w] = dropped;
      const bool edge_row = lane == 0 || lane == nrows - 1;
      sub_edge_drop |= (edge_row && dropped) || (dropped & 0x80000001u);
      tile_edge_drop |= ((r == 0 || r == BH - 1) && dropped) ||
                        (c == 0 && (dropped & 1u)) ||
                        (c == NWB - 1 && (dropped >> 31));
      if (levels && lane == 0) *levels += lv;
    }
    if (!__syncthreads_or(sub_edge_drop)) break;
  }
  // remember this round's halo
  for (int i = threadIdx.x; i < 2 * BW + 2 * BH; i += blockDim.x)
    T.halo_old[i] = T.halo[0][i];
  return __syncthreads_or(tile_edge_drop);
}

}  // namespace spt
