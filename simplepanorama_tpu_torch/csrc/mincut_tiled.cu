// Min s-t cut of a 4-connected seam grid by tiled push-relabel, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces simplepanorama_tpu/ops/maxflow.py::_mincut_tiled_kernel (the
// Pallas kernel behind grid_mincut_pallas_tiled), which the seam graph cut
// runs on grids of more than 1.2M cells. What it computes is the same min
// cut: t-links folded into a signed excess clipped to the incident
// capacity sum + 1; outer rounds of `inner_iters` push/relabel phases, then
// one global-relabel BFS (distance to the nearest sink through positive
// residual edges) that gives the next heights and the termination test;
// the source side is the set of nodes that cannot reach a sink.
//
// What bounds it on this card. Not bytes or operations: the state of a
// 1272x1280 seam block is 39 MB and a solve needs ~1 ms of both. The
// solver is bound by latency: a push phase touches ~1% of the cells, and
// the first port drove each colour of each phase as its own launch from
// a host loop (~11.8k launches of ~20 us each per solve, 35% of its
// time), and each BFS as rounds of 64x128 tiles of serial min-plus scans
// with a host read after every round (65%).
//
// Design (code in mincut_tile.cuh and mincut_bfs.cuh):
// * One cooperative launch per outer round (cudaLaunchCooperativeKernel,
//   as many CTAs as can be resident, checked with the occupancy API; a
//   refused launch raises). The host reads one flag after it: one host
//   read per BFS.
// * Push block. The tiles are 16x128 cells with a 1-cell halo in shared
//   memory (c[4], e, h and a flow plane, 69 KB), loaded by 16-byte
//   cp.async from planes of pitch W rounded up to 32. They are coloured by
//   (tile row mod 2, tile column mod 2); a grid barrier separates the
//   colours. Two tiles of one colour are two tiles apart, so the cells a
//   CTA reads or writes (its tile and the edge-adjacent halo cells) are
//   touched by no other live CTA, and a colour is the same as running its
//   tiles one after another.
// * Local phases. A tile runs TILED_LOCAL_PHASES (5) push/relabel phases
//   while it sits in shared memory, then stores itself and the halo cells
//   that received flow. That is a valid push-relabel schedule: only
//   interior cells push or lift, against halo heights that stay fixed
//   because the halo's own tile does not run in this colour; halo cells
//   only receive, and their excess waits for their own tile's turn.
//   `inner_iters` phases per round take ceil(inner_iters / 5) tile visits
//   and four grid barriers each.
// * Active tiles. A flag per tile says whether an interior cell holds
//   excess below height INF; a tile clears or keeps its own flag when it
//   stores and sets a neighbour's when a halo cell on that side does. The
//   BFS pass sets all flags anew. Idle tiles cost one flag read. A visit
//   works only the box around the tile's active cells, grown by one cell
//   per sub-step, and ends once no cell of the tile can push.
// * BFS. A seed pass packs the open-direction and sink bits, 32 cells to a
//   word. Then rounds of 128x128 tiles of the incremental bit-parallel BFS
//   of mincut_bfs.cuh (halo distances enter at their own level; each tile
//   keeps its distances in shared memory from round to round) until no
//   tile edge drops, with a grid barrier and a device flag per round.
//
// Measured (H100 80GB HBM3, 700 W, chip_smoke.py and a comparison in
// turns with the first port): 254 ms per solve of the 1272x1280 seam
// block against 674-678 ms, 100 outer rounds, 103 launches, 101 host
// reads; device time from the device clock at grid barriers 100 ms in
// push blocks (~40 us per colour pass: the tile load, up to 5 phases of
// barrier-separated loops, the store) and 149 ms in 1150 BFS rounds
// (~130 us each).
//
// Built with -fmad=false so every multiply and add rounds like the plain
// PyTorch version (ops/maxflow.py::grid_mincut_tiled_ref).

#include "mincut_tile.cuh"

extern "C" {

// Floats of device scratch spt_grid_mincut_tiled needs for an (H, W) grid.
long long spt_work_floats(int H, int W) {
  return spt::state_floats(H, W) + spt::tiled_extra_floats(H, W);
}

// Solve one grid. Inputs (H, W) row-major: cap_h, cap_v, excess (float32),
// node (uint8 0/1). Outputs: side (uint8 0/1) and, unless null, dist
// (float32): the distances of the last BFS (1e18 where none). `work` is
// caller-allocated scratch of spt_work_floats(H, W) floats, `flags` of 12
// ints, both on the device. With max_outer = 0 it runs the first BFS
// only. Runs on `stream`; returns a cudaError_t code (0 on success). stats
// (host) gets {outer rounds, BFS rounds, launches, host reads, push tiles
// worked, 0, ns in push blocks, ns in BFSs, BFS levels summed over
// tiles}.
int spt_grid_mincut_tiled(const float* cap_h, const float* cap_v,
                          const float* exc, const uint8_t* node,
                          uint8_t* side, float* dist, float* work,
                          int* flags, int H, int W, int max_outer,
                          int inner_iters, int sweep_iters, void* stream,
                          long long* stats) {
  return (int)spt::tiled_solve(cap_h, cap_v, exc, node, side, dist, work,
                               flags, H, W, max_outer, inner_iters,
                               sweep_iters, (cudaStream_t)stream, stats);
}

const char* spt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
