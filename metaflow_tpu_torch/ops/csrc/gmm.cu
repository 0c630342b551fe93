// Grouped matrix multiply for Hopper (sm_90a): the dropless-MoE kernels.
//
// K5 `gmm_fwd` replaces the TPU kernel `_gmm_fwd_kernel` of
// metaflow_tpu/ops/gmm.py (launched by `_gmm_call`): y[tile] =
// x[tile] @ B[tile_group[tile]] for every 128-row tile of the grouped,
// padded layout that ops/gmm.py `make_group_layout` builds. B[g] is w[g]
// ([G, K, N], the forward) or, with w_transposed, w[g]^T read from the
// stored [G, N, K] weights (the dx of the backward, dy @ w[g]^T, with no
// transposed copy of w). An inactive tile (tile_active 0) holds only
// padding: it skips the products and writes zeros, since the output comes
// from torch.empty.
//
// K6 `gmm_dw` replaces `_gmm_dw_kernel` (launched by `_gmm_dw_call`):
// dw[g] = sum over the active tiles i of group g of x[tile i]^T dy[tile i],
// with f32 sums, written in f32 or rounded once to bf16. The TPU kernel
// walks the tiles in grid order and revisits one output block across a
// group's consecutive tiles; a CUDA grid has no order. Here one work item
// owns one (group, 128-row D block, 256-column F block): it finds its
// group's tile range by binary search over tile_group (non-decreasing, as
// the layout makes it), walks the active tiles of that range with the sum
// in registers, and writes its block once. No atomics, no second pass; a
// group with no active tile writes zeros (the JAX backward's `visited`
// mask).
//
// Arithmetic: bf16 operands on the tensor cores with f32 sums, K5 rounding
// its f32 sum once to bf16, K6 writing f32 or its f32 sum rounded once to
// bf16 (the cast the backward needs, without a second pass). The float32
// path (tests, the f32 exactness check) uses plain FMA in 64 x 64 tiles.
//
// Bound at the Mixtral-8x7B training shape (16384 routed rows in 8 groups,
// 17408 padded rows, D 4096, F 14336): one K5 or K6 launch does 2 * 16384
// * 4096 * 14336 = 1.92 TFLOP, 1.95 ms at the card's 989 TFLOP/s dense
// bf16, against 0.94 GB of weights (0.28 ms at 3.35 TB/s). So both are
// bound by operations, and only wgmma reaches the full tensor-core rate.
// Both are built for it (see their sections below): a persistent block per
// SM of one producer warpgroup and two consumer warpgroups, TMA loads into
// a four-stage ring of 128-byte-swizzled 48 KB stages on mbarriers, wgmma
// m64n256k16 with the sums in registers, and output tiles walked in bands
// of 16 row blocks so that a wave's operand rows stay in the 50 MB L2.
//
// Tails: K and N need not be multiples of the tile. TMA zero-fills past
// them; in the cp.async producers a 16-byte chunk that is whole and aligned
// is copied with cp.async, a partial or unaligned one element by element
// and zero-filled, so any shape is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
#include "tile_mma.cuh"

namespace {

using namespace hopper;
using namespace tile_mma;

constexpr int TILE = 128;  // rows of a layout tile (block_s)
constexpr int BAND = 16;   // row blocks per band of the block order

// The (row block, column block) of linear block `pid` over an m x n grid of
// output blocks, walked in bands of BAND row blocks, column by column.
__device__ __forceinline__ void band_order(int pid, int m, int n, int& bm,
                                           int& bn) {
  const int per_band = BAND * n;
  const int first = (pid / per_band) * BAND;
  const int rows = min(m - first, BAND);
  const int in_band = pid % per_band;
  bm = first + in_band % rows;
  bn = in_band / rows;
}

// 8 bf16 values at src[0, 8) into shared dst, zero past `valid` (0..8).
__device__ __forceinline__ void load_chunk(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int valid) {
  if (valid >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async_16(dst, src, true);
  } else if (valid <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = e < valid ? src[e] : __float2bfloat16(0.f);
  }
}

// ---------------------------------------------------------------------------
// K5: bf16 wgmma kernel, warp-specialised and persistent
// ---------------------------------------------------------------------------
//
// One block per SM walks the output tiles (128 rows x 256 columns) in
// band_order. Warpgroup 0 is the producer: one warp fills a ring of
// STAGES shared-memory stages, each a 128 x 64 slice of x and a 64 x 256
// slice of B, and marks it full on its mbarrier; it skips inactive tiles
// itself. Warpgroups 1 and 2 are the consumers, 64 rows each: they wait for
// a full stage, run four wgmma m64n256k16 on it with the f32 sums in
// registers (128 a thread), and hand the stage back on its empty mbarrier
// once the wgmma that read it have finished (one group stays in flight).
// The epilogue rounds the sums to bf16 and stores them while the producer
// already fills the next tile's stages; an inactive tile's consumers store
// zeros without waiting on a stage.
//
// Two producers fill the same swizzled stages. kTma: one thread issues TMA
// loads (x as a 2D map over [S, K], w as a 3D map over [G, K, N], or
// [G, N, K] when transposed, the group as the outer coordinate), and TMA
// zero-fills past K and N. Otherwise (an operand whose base or row stride
// is not 16-byte aligned, which a tensor map cannot describe) the producer
// warp copies 16-byte chunks with cp.async where they are whole and
// aligned and element by element at the ragged edge, zero-filled
// (load_chunk), and each lane arrives on the full barrier.
//
// B's major: the forward's w[g] is [K, N], N contiguous, so B is MN-major
// (four [64 k][64 n] boxes a stage); the dx's is [N, K], K-major (one
// [256 n][64 k] box). The descriptor and wgmma's transpose bit take either,
// so dx needs no copy of w.

constexpr int WG_BM = 128;  // output rows per tile (two consumers of 64)
constexpr int WG_BN = 256;  // output columns per tile
constexpr int WG_BK = 64;   // reduction depth of a stage: one 128-byte row
constexpr int WG_STAGES = 4;
constexpr int WG_THREADS = 384;  // producer + two consumer warpgroups
constexpr int A_BYTES = WG_BM * WG_BK * 2;          // [128][64]
constexpr int B_BYTES = WG_BN * WG_BK * 2;     // [256][64] or 4 x [64][64]
constexpr int B_BOX_BYTES = 64 * WG_BK * 2;         // one [64][64] box
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;      // 48 KB
constexpr int WG_SMEM = 1024 + WG_STAGES * STAGE_BYTES + 2 * WG_STAGES * 8;

struct FwdParams {
  const __nv_bfloat16* x;  // [S, K], rows ldx apart
  const __nv_bfloat16* w;  // [G, K, N] or, transposed, [G, N, K]
  __nv_bfloat16* y;        // [S, N], rows ldy apart
  const int* tile_group;
  const int* tile_active;
  int n_tiles, K, N;
  long long ldx, ldy, w_sg, w_ld;  // w_ld: stride of w[g]'s leading dim
};

// Byte offset of element (r, c) of a [rows][64] bf16 box with the 128-byte
// swizzle, as TMA writes it.
__device__ __forceinline__ int swizzle_128b(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// The cp.async producer: one warp fills stage (sa, sb) with k slice kt of
// tile `tile` (group g) and column block n0, zero past K and N.
template <bool kTrans>
__device__ __forceinline__ void fill_stage(unsigned char* sa,
                                           unsigned char* sb,
                                           const FwdParams& p, int tile,
                                           int g, int kt, int n0, int lane) {
  const int k0 = kt * WG_BK;
  const __nv_bfloat16* xs =
      p.x + static_cast<long long>(tile) * TILE * p.ldx + k0;
  for (int c = lane; c < WG_BM * 8; c += 32) {  // x: [128 rows][64 k]
    const int r = c >> 3, col = (c & 7) * 8;
    load_chunk(reinterpret_cast<__nv_bfloat16*>(sa + swizzle_128b(r, col)),
               xs + r * p.ldx + col, p.K - k0 - col);
  }
  const __nv_bfloat16* wg = p.w + g * p.w_sg;
  for (int c = lane; c < WG_BN * 8; c += 32) {
    if (kTrans) {  // [256 n][64 k], K-major
      const int r = c >> 3, col = (c & 7) * 8;
      const int valid = n0 + r < p.N ? p.K - k0 - col : 0;
      load_chunk(reinterpret_cast<__nv_bfloat16*>(sb + swizzle_128b(r, col)),
                 wg + (valid > 0 ? (n0 + r) * p.w_ld + k0 + col : 0), valid);
    } else {  // four [64 k][64 n] boxes, MN-major
      const int box = c >> 9, r = (c >> 3) & 63, col = (c & 7) * 8;
      const int n = n0 + box * 64 + col;
      const int valid = k0 + r < p.K ? p.N - n : 0;
      load_chunk(reinterpret_cast<__nv_bfloat16*>(sb + box * B_BOX_BYTES +
                                                  swizzle_128b(r, col)),
                 wg + (valid > 0 ? (k0 + r) * p.w_ld + n : 0), valid);
    }
  }
}

template <bool kTrans, bool kTma>
__global__ void __launch_bounds__(WG_THREADS, 1)
    gmm_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w,
                         FwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WG_STAGES * STAGE_BYTES);
  uint64_t* empty = full + WG_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], kTma ? 1 : 32);  // the TMA thread, or each lane
      mbar_init(&empty[s], 2);             // one thread of each consumer
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int n_cols = (p.N + WG_BN - 1) / WG_BN;
  const int total = p.n_tiles * n_cols;
  const int nk = (p.K + WG_BK - 1) / WG_BK;

  if (threadIdx.x < 128) {  // the producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int stage = 0;
    uint32_t write_phase = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int tile, nb;
      band_order(t, p.n_tiles, n_cols, tile, nb);
      if (p.tile_active[tile] == 0) continue;  // its consumers store zeros
      const int g = p.tile_group[tile];
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&empty[stage], write_phase ^ 1);
        unsigned char* sa = smem + stage * STAGE_BYTES;
        unsigned char* sb = sa + A_BYTES;
        if (kTma) {
          if (lane == 0) {
            mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
            tma_load_2d(sa, &tm_x, &full[stage], kt * WG_BK, tile * TILE);
            if (kTrans) {
              tma_load_3d(sb, &tm_w, &full[stage], kt * WG_BK, nb * WG_BN, g);
            } else {
#pragma unroll
              for (int j = 0; j < WG_BN / 64; ++j)
                tma_load_3d(sb + j * B_BOX_BYTES, &tm_w, &full[stage],
                            nb * WG_BN + j * 64, kt * WG_BK, g);
            }
          }
        } else {
          fill_stage<kTrans>(sa, sb, p, tile, g, kt, nb * WG_BN, lane);
          cp_async_commit();
          cp_async_wait<0>();
          fence_proxy_async();  // the copies, before wgmma reads them
          mbar_arrive(&full[stage]);
        }
        if (++stage == WG_STAGES) {
          stage = 0;
          write_phase ^= 1;
        }
      }
    }
  } else {  // a consumer warpgroup: 64 rows of each tile
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    int stage = 0;
    uint32_t read_phase = 0;
    float acc[128];
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int tile, nb;
      band_order(t, p.n_tiles, n_cols, tile, nb);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      const bool active = p.tile_active[tile] != 0;
      if (active) {
        int held = -1;  // the stage the wgmma group in flight reads
        for (int kt = 0; kt < nk; ++kt) {  // K5 k loop
          mbar_wait(&full[stage], read_phase);
          const unsigned char* sa = smem + stage * STAGE_BYTES + c * 64 * 128;
          const unsigned char* sb = smem + stage * STAGE_BYTES + A_BYTES;
          fence_operand(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < WG_BK / 16; ++kk) {
            const uint64_t da = desc_k_major(sa + kk * 32);
            if (kTrans)
              wgmma_m64n256k16_ss<0>(acc, da, desc_k_major(sb + kk * 32), 1);
            else
              wgmma_m64n256k16_ss<1>(
                  acc, da, desc_mn_major(sb + kk * 16 * 128, B_BOX_BYTES), 1);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous k slice's group has finished
          fence_operand(acc);
          if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);
          held = stage;
          if (++stage == WG_STAGES) {
            stage = 0;
            read_phase ^= 1;
          }
        }
        wgmma_wait<0>();
        fence_operand(acc);
        if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);
      }
      // epilogue: this thread's rows r and r + 8, column pairs 8j + 2(l%4)
      const long long r = static_cast<long long>(tile) * TILE + c * 64 +
                          warp * 16 + lane / 4;
      const int c0 = nb * WG_BN + (lane % 4) * 2;
#pragma unroll
      for (int j = 0; j < WG_BN / 8; ++j) {
        const int col = c0 + j * 8;
        if (col >= p.N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat16* dst = p.y + (r + h * 8) * p.ldy + col;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (col + 1 < p.N && (reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
            *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
          } else {
            dst[0] = __float2bfloat16(v0);
            if (col + 1 < p.N) dst[1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K6: bf16 wgmma kernel, warp-specialised and persistent
// ---------------------------------------------------------------------------
//
// dw[g] = x_g^T dy_g is a product whose reduction runs over the group's
// rows: M = D, N = F, K = rows. One block per SM walks the work items
// (group, 128 D rows, 256 F columns), the groups with the most active tiles
// first (ranked by each block at its start) and, within a group, the
// output blocks in band_order. Warpgroup 0 is the producer: one warp
// walks the active tiles of the item's group and fills a ring of
// WG_STAGES stages, each 64 layout rows of x (A, two [64 rows][64 d] boxes)
// and of dy (B, four [64 rows][64 f] boxes), and marks it full on its
// mbarrier. A is x^T, whose M dimension (D) is the contiguous one, so A is
// MN-major and read with wgmma's transpose bit for A; B is MN-major like
// K5's forward weights. Warpgroups 1 and 2 are the consumers, 64 D rows
// each: per stage four wgmma m64n256k16 with the f32 sums in registers
// (128 a thread), the stage handed back once the wgmma that read it have
// finished (one group stays in flight). The epilogue writes the item's
// block once, in f32 or rounded once to bf16, while the producer already
// fills the next item's stages. Uneven groups only change an item's length;
// at Mixtral's widths a launch has about 100 waves of items, so the groups
// are not split along their rows.
//
// Two producers fill the same swizzled stages, as in K5: kTma, one thread
// issues TMA loads from 2D maps over x [S, D] and dy [S, F], which
// zero-fill past D and F; otherwise (a base or row stride not 16-byte
// aligned) the producer warp copies with cp.async and element by element
// at the ragged edge (fill_dw_stage), and each lane arrives on the full
// barrier.

constexpr int DW_BM = 128;  // D rows of an item (two consumers of 64)
constexpr int DW_BN = 256;  // F columns of an item
constexpr int DW_BK = 64;   // layout rows of a stage
constexpr int DW_BOX = 64 * 128;                         // one [64][64] box
constexpr int DW_A_BYTES = (DW_BM / 64) * DW_BOX;        // 16 KB
constexpr int DW_STAGE_BYTES = DW_A_BYTES + (DW_BN / 64) * DW_BOX;  // 48 KB
constexpr int DW_MAX_GROUPS = 1024;  // groups a block ranks in smem
constexpr int DW_SMEM = 1024 + WG_STAGES * DW_STAGE_BYTES +
                        2 * WG_STAGES * 8 + 2 * DW_MAX_GROUPS * 4;

struct DwParams {
  const __nv_bfloat16* x;   // [S, D], rows ldx apart
  const __nv_bfloat16* dy;  // [S, F], rows lddy apart
  void* dw;                 // [G, D, F], contiguous, f32 or bf16
  const int* tile_group;
  const int* tile_active;
  int n_tiles, D, F, G;
  long long ldx, lddy;
};

// The first index i of the non-decreasing tile_group with
// tile_group[i] >= g (n when there is none).
__device__ __forceinline__ int lower_bound(const int* tile_group, int n,
                                           int g) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tile_group[mid] < g) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The cp.async producer: one warp fills stage (sa, sb) with layout rows
// [row, row + 64) of x's columns [d0, d0 + 128) and dy's [f0, f0 + 256),
// zero past D and F.
__device__ __forceinline__ void fill_dw_stage(unsigned char* sa,
                                              unsigned char* sb,
                                              const DwParams& p, long long row,
                                              int d0, int f0, int lane) {
  for (int c = lane; c < (DW_BM / 64) * 512; c += 32) {  // x: 2 boxes
    const int box = c >> 9, r = (c >> 3) & 63, col = (c & 7) * 8;
    const int d = d0 + box * 64 + col;
    const int valid = p.D - d;
    load_chunk(reinterpret_cast<__nv_bfloat16*>(sa + box * DW_BOX +
                                                swizzle_128b(r, col)),
               p.x + (valid > 0 ? (row + r) * p.ldx + d : 0), valid);
  }
  for (int c = lane; c < (DW_BN / 64) * 512; c += 32) {  // dy: 4 boxes
    const int box = c >> 9, r = (c >> 3) & 63, col = (c & 7) * 8;
    const int f = f0 + box * 64 + col;
    const int valid = p.F - f;
    load_chunk(reinterpret_cast<__nv_bfloat16*>(sb + box * DW_BOX +
                                                swizzle_128b(r, col)),
               p.dy + (valid > 0 ? (row + r) * p.lddy + f : 0), valid);
  }
}

// The ring's next stage, flipping the phase bit at the wrap.
__device__ __forceinline__ void next_stage(int& stage, uint32_t& phase) {
  if (++stage == WG_STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

template <bool kTma, bool kOutBf16>
__global__ void __launch_bounds__(WG_THREADS, 1)
    gmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_dy,
                        DwParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + WG_STAGES * DW_STAGE_BYTES);
  uint64_t* empty = full + WG_STAGES;
  int* count = reinterpret_cast<int*>(empty + WG_STAGES);  // [G]
  int* order = count + DW_MAX_GROUPS;  // order[rank] = group

  // rank the groups by their active tiles, heaviest first (ties by index)
  for (int g = threadIdx.x; g < p.G; g += blockDim.x) count[g] = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], kTma ? 1 : 32);  // the TMA thread, or each lane
      mbar_init(&empty[s], 2);             // one thread of each consumer
    }
    mbar_fence_init();
  }
  __syncthreads();
  for (int t = threadIdx.x; t < p.n_tiles; t += blockDim.x)
    if (p.tile_active[t] != 0) atomicAdd(&count[p.tile_group[t]], 1);
  __syncthreads();
  for (int g = threadIdx.x; g < p.G; g += blockDim.x) {
    int rank = 0;
    for (int h = 0; h < p.G; ++h)
      rank += count[h] > count[g] || (count[h] == count[g] && h < g);
    order[rank] = g;
  }
  __syncthreads();

  const int n_d = (p.D + DW_BM - 1) / DW_BM, n_f = (p.F + DW_BN - 1) / DW_BN;
  const int per_group = n_d * n_f;
  const int total = p.G * per_group;
  // work item i: its group, D block and F block
  auto item = [&](int i, int& g, int& db, int& fb) {
    g = order[i / per_group];
    band_order(i % per_group, n_d, n_f, db, fb);
  };

  if (threadIdx.x < 128) {  // the producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int stage = 0;
    uint32_t write_phase = 0;
    for (int i = blockIdx.x; i < total; i += gridDim.x) {
      int g, db, fb;
      item(i, g, db, fb);
      const int first = lower_bound(p.tile_group, p.n_tiles, g);
      const int last = lower_bound(p.tile_group, p.n_tiles, g + 1);
      for (int t = first; t < last; ++t) {
        if (p.tile_active[t] == 0) continue;  // K6 skips inactive tiles
        for (int h = 0; h < TILE / DW_BK; ++h) {
          mbar_wait(&empty[stage], write_phase ^ 1);
          unsigned char* sa = smem + stage * DW_STAGE_BYTES;
          unsigned char* sb = sa + DW_A_BYTES;
          const int row = t * TILE + h * DW_BK;
          if (kTma) {
            if (lane == 0) {
              mbar_arrive_expect_tx(&full[stage], DW_STAGE_BYTES);
#pragma unroll
              for (int j = 0; j < DW_BM / 64; ++j)
                tma_load_2d(sa + j * DW_BOX, &tm_x, &full[stage],
                            db * DW_BM + j * 64, row);
#pragma unroll
              for (int j = 0; j < DW_BN / 64; ++j)
                tma_load_2d(sb + j * DW_BOX, &tm_dy, &full[stage],
                            fb * DW_BN + j * 64, row);
            }
          } else {
            fill_dw_stage(sa, sb, p, row, db * DW_BM, fb * DW_BN, lane);
            cp_async_commit();
            cp_async_wait<0>();
            fence_proxy_async();  // the copies, before wgmma reads them
            mbar_arrive(&full[stage]);
          }
          next_stage(stage, write_phase);
        }
      }
    }
  } else {  // a consumer warpgroup: 64 D rows of each item
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    int stage = 0;
    uint32_t read_phase = 0;
    float acc[128];
    for (int i = blockIdx.x; i < total; i += gridDim.x) {
      int g, db, fb;
      item(i, g, db, fb);
      const int first = lower_bound(p.tile_group, p.n_tiles, g);
      const int last = lower_bound(p.tile_group, p.n_tiles, g + 1);
#pragma unroll
      for (int e = 0; e < 128; ++e) acc[e] = 0.f;
      int held = -1;  // the stage the wgmma group in flight reads
      for (int t = first; t < last; ++t) {
        if (p.tile_active[t] == 0) continue;  // K6 skips inactive tiles
        for (int h = 0; h < TILE / DW_BK; ++h) {
          mbar_wait(&full[stage], read_phase);
          const unsigned char* sa =
              smem + stage * DW_STAGE_BYTES + c * DW_BOX;
          const unsigned char* sb =
              smem + stage * DW_STAGE_BYTES + DW_A_BYTES;
          fence_operand(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DW_BK / 16; ++kk)
            wgmma_m64n256k16_ss<1, 1>(
                acc, desc_mn_major(sa + kk * 16 * 128, DW_BOX),
                desc_mn_major(sb + kk * 16 * 128, DW_BOX), 1);
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's group has finished
          fence_operand(acc);
          if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);
          held = stage;
          next_stage(stage, read_phase);
        }
      }
      wgmma_wait<0>();
      fence_operand(acc);
      if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);

      // epilogue: this thread's D rows d and d + 8, F column pairs
      // 8j + 2(l%4); a group with no active tile writes zeros
      const int d = db * DW_BM + c * 64 + warp * 16 + lane / 4;
      const int f0 = fb * DW_BN + (lane % 4) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = d + h * 8;
        if (row >= p.D) continue;
        const long long base = (static_cast<long long>(g) * p.D + row) * p.F;
#pragma unroll
        for (int j = 0; j < DW_BN / 8; ++j) {
          const int col = f0 + j * 8;
          if (col >= p.F) continue;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (kOutBf16) {
            __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.dw) + base +
                                 col;
            if (col + 1 < p.F && (reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
              *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
            } else {
              dst[0] = __float2bfloat16(v0);
              if (col + 1 < p.F) dst[1] = __float2bfloat16(v1);
            }
          } else {
            float* dst = static_cast<float*>(p.dw) + base + col;
            if (col + 1 < p.F && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            } else {
              dst[0] = v0;
              if (col + 1 < p.F) dst[1] = v1;
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 kernels: 64 x 64 output tiles, 4 x 4 per thread, FMA only
// ---------------------------------------------------------------------------

constexpr int FB = 64;  // output tile edge
constexpr int FK = 16;  // reduction depth per step

struct F32Params {
  const float* x;
  const float* w;  // K5: w; K6: dy
  float* y;        // K5: y; K6: dw
  const int* tile_group;
  const int* tile_active;
  int n_tiles, K, N, trans;
  long long ldx, ldy, w_sg, w_ld;
};

// The 4 x 4 outputs of thread (ty, tx) += sA[k][ty*4 + i] * sB[k][tx*4 + j].
__device__ __forceinline__ void fma_tile(float (&acc)[4][4],
                                         const float (*sA)[FB + 1],
                                         const float (*sB)[FB + 1], int ty,
                                         int tx) {
#pragma unroll
  for (int k = 0; k < FK; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = sA[k][ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = sB[k][tx * 4 + j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// K5 in f32: one block per (64-row half of a tile, 64-column block).
__global__ void __launch_bounds__(256) gmm_fwd_f32_kernel(F32Params p) {
  __shared__ float sA[FK][FB + 1];  // x, k-major
  __shared__ float sB[FK][FB + 1];  // w[g], k-major
  const int rb = blockIdx.y, n0 = blockIdx.x * FB;
  const int tile = rb * FB / TILE;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long r0 = static_cast<long long>(rb) * FB;
  if (p.tile_active[tile] == 0) {
    for (int i = tid; i < FB * FB; i += 256) {
      const int c = n0 + i % FB;
      if (c < p.N) p.y[(r0 + i / FB) * p.ldy + c] = 0.f;
    }
    return;
  }
  const float* wg = p.w + p.tile_group[tile] * p.w_sg;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.K; k0 += FK) {
    for (int i = tid; i < FB * FK; i += 256) {
      const int r = i / FK, k = i % FK;  // x rows
      sA[k][r] = k0 + k < p.K ? p.x[(r0 + r) * p.ldx + k0 + k] : 0.f;
      const int kb = i / FB, n = i % FB;  // w: B[k][n]
      float v = 0.f;
      if (k0 + kb < p.K && n0 + n < p.N)
        v = p.trans ? wg[(n0 + n) * p.w_ld + k0 + kb]
                    : wg[(k0 + kb) * p.w_ld + n0 + n];
      sB[kb][n] = v;
    }
    __syncthreads();
    fma_tile(acc, sA, sB, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < p.N) p.y[(r0 + ty * 4 + i) * p.ldy + c] = acc[i][j];
    }
}

// K6 in f32: one block per (group, 64-row D block, 64-column F block).
__global__ void __launch_bounds__(256) gmm_dw_f32_kernel(F32Params p) {
  __shared__ float sA[FK][FB + 1];  // x rows, D columns
  __shared__ float sB[FK][FB + 1];  // dy rows, F columns
  const int g = blockIdx.z, d0 = blockIdx.y * FB, f0 = blockIdx.x * FB;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int first = lower_bound(p.tile_group, p.n_tiles, g);
  const int last = lower_bound(p.tile_group, p.n_tiles, g + 1);
  float acc[4][4] = {};
  for (int t = first; t < last; ++t) {
    if (p.tile_active[t] == 0) continue;
    for (int k0 = 0; k0 < TILE; k0 += FK) {
      const long long row0 = static_cast<long long>(t) * TILE + k0;
      for (int i = tid; i < FB * FK; i += 256) {
        const int k = i / FB, c = i % FB;
        sA[k][c] = d0 + c < p.K ? p.x[(row0 + k) * p.ldx + d0 + c] : 0.f;
        sB[k][c] = f0 + c < p.N ? p.w[(row0 + k) * p.ldy + f0 + c] : 0.f;
      }
      __syncthreads();
      fma_tile(acc, sA, sB, ty, tx);
      __syncthreads();
    }
  }
  float* out = p.y + static_cast<long long>(g) * p.K * p.N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + ty * 4 + i, f = f0 + tx * 4 + j;
      if (d < p.K && f < p.N) out[static_cast<long long>(d) * p.N + f] =
          acc[i][j];
    }
}

cudaError_t set_smem(const void* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// K5 in bf16: the tensor maps (kTma; encoding reads no device memory), then
// one persistent block per SM, at most one per output tile.
template <bool kTrans, bool kTma>
cudaError_t launch_fwd_wgmma(const FwdParams& p, int G, int device,
                             cudaStream_t st) {
  CUtensorMap tm_x, tm_w;
  memset(&tm_x, 0, sizeof(tm_x));
  memset(&tm_w, 0, sizeof(tm_w));
  cudaError_t err;
  if (kTma) {
    const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(p.K),
                                  static_cast<cuuint64_t>(p.n_tiles) * TILE};
    const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(p.ldx) * 2};
    const cuuint32_t x_box[2] = {WG_BK, WG_BM};
    err = make_map_bf16(&tm_x, p.x, 2, x_dims, x_strides, x_box);
    if (err != cudaSuccess) return err;
    const cuuint64_t inner = kTrans ? p.K : p.N, outer = kTrans ? p.N : p.K;
    const cuuint64_t w_dims[3] = {inner, outer, static_cast<cuuint64_t>(G)};
    const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(p.w_ld) * 2,
                                     static_cast<cuuint64_t>(p.w_sg) * 2};
    const cuuint32_t w_rows = kTrans ? WG_BN : WG_BK;
    const cuuint32_t w_box[3] = {64, w_rows, 1};
    err = make_map_bf16(&tm_w, p.w, 3, w_dims, w_strides, w_box);
    if (err != cudaSuccess) return err;
  }
  const void* kernel =
      reinterpret_cast<const void*>(gmm_fwd_wgmma_kernel<kTrans, kTma>);
  err = set_smem(kernel, WG_SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = p.n_tiles * ((p.N + WG_BN - 1) / WG_BN);
  const int sms = sm_count(device);
  const int grid = tiles < sms ? tiles : sms;
  if (grid <= 0) return cudaErrorInvalidValue;
  gmm_fwd_wgmma_kernel<kTrans, kTma>
      <<<grid, WG_THREADS, WG_SMEM, st>>>(tm_x, tm_w, p);
  return cudaGetLastError();
}

// K6 in bf16: the tensor maps (kTma), then one persistent block per SM, at
// most one per work item.
template <bool kTma, bool kOutBf16>
cudaError_t launch_dw_wgmma(const DwParams& p, int device, cudaStream_t st) {
  CUtensorMap tm_x, tm_dy;
  memset(&tm_x, 0, sizeof(tm_x));
  memset(&tm_dy, 0, sizeof(tm_dy));
  cudaError_t err;
  if (kTma) {
    const cuuint64_t rows = static_cast<cuuint64_t>(p.n_tiles) * TILE;
    const cuuint32_t box[2] = {64, DW_BK};
    const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(p.D), rows};
    const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(p.ldx) * 2};
    err = make_map_bf16(&tm_x, p.x, 2, x_dims, x_strides, box);
    if (err != cudaSuccess) return err;
    const cuuint64_t dy_dims[2] = {static_cast<cuuint64_t>(p.F), rows};
    const cuuint64_t dy_strides[1] = {static_cast<cuuint64_t>(p.lddy) * 2};
    err = make_map_bf16(&tm_dy, p.dy, 2, dy_dims, dy_strides, box);
    if (err != cudaSuccess) return err;
  }
  const void* kernel =
      reinterpret_cast<const void*>(gmm_dw_wgmma_kernel<kTma, kOutBf16>);
  err = set_smem(kernel, DW_SMEM);
  if (err != cudaSuccess) return err;
  const int items =
      p.G * ((p.D + DW_BM - 1) / DW_BM) * ((p.F + DW_BN - 1) / DW_BN);
  const int sms = sm_count(device);
  const int grid = items < sms ? items : sms;
  if (grid <= 0) return cudaErrorInvalidValue;
  gmm_dw_wgmma_kernel<kTma, kOutBf16>
      <<<grid, WG_THREADS, DW_SMEM, st>>>(tm_x, tm_dy, p);
  return cudaGetLastError();
}

}  // namespace

// C entry points, loaded with ctypes. Strides are in elements; the last
// dimension of every tensor is contiguous. dtype: 0 = float32, 1 = bf16.
// S (rows of x and y) is a multiple of the 128-row layout tile. Each
// returns the CUDA error code of the launch (0 on success).

// K5: y [S, N] = per tile x [S, K] @ B[tile_group[tile]], with B[g] = w[g]
// ([G, K, N]) or, when w_transposed, w[g]^T (w [G, N, K]). w_ld is the
// stride of w[g]'s first dimension. In bf16, use_tma picks the TMA
// producer (every base 16-byte aligned and every row stride a multiple of
// 16 bytes, which the wrapper checks) or the cp.async one.
extern "C" int gmm_fwd(const void* x, const void* w, void* y,
                       const void* tile_group, const void* tile_active, int S,
                       int K, int N, int G, long long ldx, long long ldy,
                       long long w_sg, long long w_ld, int w_transposed,
                       int use_tma, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = S / TILE;
  const int* tg = static_cast<const int*>(tile_group);
  const int* ta = static_cast<const int*>(tile_active);
  if (n_tiles == 0 || N == 0) return 0;
  if (dtype == 1) {
    FwdParams p{static_cast<const __nv_bfloat16*>(x),
                static_cast<const __nv_bfloat16*>(w),
                static_cast<__nv_bfloat16*>(y), tg, ta, n_tiles, K, N, ldx,
                ldy, w_sg, w_ld};
    if (w_transposed)
      err = use_tma ? launch_fwd_wgmma<true, true>(p, G, device, st)
                    : launch_fwd_wgmma<true, false>(p, G, device, st);
    else
      err = use_tma ? launch_fwd_wgmma<false, true>(p, G, device, st)
                    : launch_fwd_wgmma<false, false>(p, G, device, st);
    return static_cast<int>(err);
  } else if (dtype == 0) {
    F32Params p{static_cast<const float*>(x), static_cast<const float*>(w),
                static_cast<float*>(y), tg, ta, n_tiles, K, N, w_transposed,
                ldx, ldy, w_sg, w_ld};
    dim3 grid((N + FB - 1) / FB, S / FB);
    gmm_fwd_f32_kernel<<<grid, 256, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of one bf16 K5 block, in bytes.
extern "C" int gmm_fwd_smem_bytes() { return WG_SMEM; }

// K6: dw [G, D, F] (contiguous) = per group the sum over its active tiles
// of x[tile]^T dy[tile]; x [S, D], dy [S, F]. dw is f32, or with out_bf16
// (bf16 operands only) the f32 sums rounded once to bf16. In bf16, use_tma
// picks the TMA producer or the cp.async one as for K5; G is at most
// gmm_dw_max_groups().
extern "C" int gmm_dw(const void* x, const void* dy, void* dw,
                      const void* tile_group, const void* tile_active, int S,
                      int D, int F, int G, long long ldx, long long lddy,
                      int use_tma, int out_bf16, int dtype, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = S / TILE;
  const int* tg = static_cast<const int*>(tile_group);
  const int* ta = static_cast<const int*>(tile_active);
  if (G == 0 || D == 0 || F == 0) return 0;
  if (dtype == 1) {
    if (G > DW_MAX_GROUPS) return static_cast<int>(cudaErrorInvalidValue);
    DwParams p{static_cast<const __nv_bfloat16*>(x),
               static_cast<const __nv_bfloat16*>(dy), dw, tg, ta, n_tiles, D,
               F, G, ldx, lddy};
    if (out_bf16)
      err = use_tma ? launch_dw_wgmma<true, true>(p, device, st)
                    : launch_dw_wgmma<false, true>(p, device, st);
    else
      err = use_tma ? launch_dw_wgmma<true, false>(p, device, st)
                    : launch_dw_wgmma<false, false>(p, device, st);
    return static_cast<int>(err);
  } else if (dtype == 0 && !out_bf16) {
    F32Params p{static_cast<const float*>(x), static_cast<const float*>(dy),
                static_cast<float*>(dw), tg, ta, n_tiles, D, F, 0,
                ldx, lddy, 0, 0};
    dim3 grid((F + FB - 1) / FB, (D + FB - 1) / FB, G);
    gmm_dw_f32_kernel<<<grid, 256, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of one bf16 K6 block, in bytes, and the most
// groups it ranks.
extern "C" int gmm_dw_smem_bytes() { return DW_SMEM; }
extern "C" int gmm_dw_max_groups() { return DW_MAX_GROUPS; }
