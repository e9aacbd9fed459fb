// Flash-attention backward for NVIDIA Hopper (sm_90a): two kernels.
//
// Replace the Pallas TPU kernels of kubeshare_tpu/ops/attention.py,
// launched by _flash_backward:
//   flash_bwd_dq   <- _flash_bwd_dq_kernel
//   flash_bwd_dkv  <- _flash_bwd_dkv_kernel
// Their plain PyTorch version is flash_backward_reference in
// ../attention.py.
//
// FlashAttention-2 decomposition. With lse the forward's row
// log-sum-exp and delta' = rowsum(dO * O) - g_lse (computed by the
// wrapper, outside any kernel, as the reference does):
//   P  = exp(scale * q k^T - lse)        (0 where masked)
//   dP = dO v^T,   dS = P * (dP - delta')
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = P^T dO
//
// Layout. q, dO [B*H, Tq, D], k/v [B*Hkv, Tk, D], lse and delta' [B*H, Tq]
// float32; dq like q, dk/dv like k; all contiguous and 16-byte aligned.
// The kv head of query head bh is (bh / H) * Hkv + (bh % H) / (H / Hkv):
// K/V are never repeated, and dk/dv sum a group's H / Hkv query heads.
//
// Numerics kept from the reference: masked scores -1e30 (P = 0 there);
// products of input-dtype values accumulated in float32; P rounded to
// dO's dtype before P^T dO, dS to k's dtype before dS K and to q's dtype
// before dS^T Q; dk and dv summed over the group in float32, then cast.
// Ragged edges: rows past Tq and keys past Tk are zero-filled, masked and
// not written. No atomics whose order varies: two launches on the same
// inputs give the same bits.
//
// What bounds them on the H100. At the Llama-3-8B shape (B=1, H=32,
// Hkv=8, T=2048, D=128, causal, bf16; 67.1 M visible pairs) dq does 6 D
// operations per visible pair (Q K^T, dO V^T, dS K), 51.6 GFLOP, and dkv
// 8 D (Q K^T, dO V^T, P^T dO, dS^T Q), 68.7 GFLOP, against about 60 MB of
// traffic each: 0.052 and 0.070 ms at 989 TFLOP/s of bf16 tensor-core
// peak, 0.018 ms at 3.35 TB/s. Both are bound by operations, and on
// Hopper only wgmma fed from shared memory that TMA filled reaches that
// peak. The mma.sync kernels these replaced reached 21 % (dq) and 12 %
// (dkv) of the bound: 4 warps of 16 rows ran each product and then the
// softmax in turn, every thread spent registers and instructions on
// cp.async addresses, and dkv walked all of a GQA group's heads in one
// block per key tile, so under a causal mask key tile 0 walked 4 x 2048
// rows while the last walked 4 x 64: the kernel took as long as the
// non-causal one, which does twice the work.
//
// The bf16 kernels are warp-specialised, after FlashAttention-3's
// backward, with the forward's tools (hopper.cuh):
// - 384 threads: two consumer warpgroups and a producer warpgroup whose
//   first thread starts every TMA load (3-D tensor maps: rows past a
//   ragged T are zero-filled inside their own head) and which gives its
//   registers (setmaxnreg, 24 against the consumers' 240) away. The tiles
//   an item keeps (dq: Q and dO; dkv: K and V) are double-buffered, so
//   the next item's load overlaps this one; the tiles it streams go
//   through a ring with full/empty mbarriers: 3 stages in dq, where 2
//   left the loads' latency exposed, and 2 in dkv, where 3 were no
//   faster (timed on an H100; PERF.md section 6).
// - A persistent grid, one block per SM, walks work items built on the
//   host (flash_forward_schedule and flash_backward_schedule in
//   ../attention.py): longest first, dealt in a snake, so each block's
//   work is even to within one item.
// - dq: an item is (b*h, 128 query rows, their keys): the forward's items,
//   with 64-key K/V tiles. Each consumer warpgroup owns 64 rows:
//   S = Q K^T and dP = dO V^T are wgmma with both operands in swizzled
//   shared memory (the forward's boxes, hopper.cuh Tile); P and dS = P (dP - delta') are formed in
//   registers (an FFMA and an ex2 each) and dS packed to bf16 A
//   fragments; dQ += dS K is a wgmma with dS from registers and K read
//   MN-major (the transpose bit) from the tile that fed S. dS K of tile j
//   runs while S and dP of tile j + 1 are formed. 64-key tiles keep S, dP,
//   dQ and the dS fragments at 32 + 32 + 64 + 16 registers a thread at
//   D = 128; 128-key tiles would not fit.
// - dkv: an item is (b*kv head, 128 keys, ONE query head r of the group)
//   with the 64-row q tiles that see its keys: splitting the group by head
//   makes the longest item one head's rows, so the snake can even the
//   blocks out. Each consumer warpgroup owns 64 keys: S^T = K Q^T and
//   dP^T = V dO^T (wgmma SS); P^T and dS^T in registers, where lse and
//   delta' are per column, read from shared memory (1-D TMA boxes of the
//   q tile's 64 rows, from rows the caller pads to a multiple of 4 so
//   that every box starts 16-byte aligned; an unaligned start faulted);
//   dV += P^T dO and dK += dS^T Q (wgmma RS, dO and Q read MN-major
//   from the tiles that fed the first two). dV runs while dS^T is
//   formed.
// - The group's sum is ordered, so it stays deterministic: item r of a
//   (b*kv head, key tile) waits on the tile's counter until items 0..r-1
//   are done, adds its float32 partial to theirs in a scratch buffer
//   (laid out as the accumulators are, so each thread moves whole float4s)
//   and releases the counter to r + 1; the last item scales, casts and
//   writes dk and dv. With one head per group an item writes directly.
//   This cannot deadlock because (a) every block walks its items in
//   increasing list order; (b) item r waits only on item r - 1 of its
//   tile, which the list puts earlier (items of equal length are ordered
//   by tile, then r); and (c) the grid is at most one block per SM (the
//   shared memory allows no second), so every block is resident or gets
//   an SM that a finished block frees: the earliest unfinished item of
//   the list can always run.
// - Tiles that no pair of a warpgroup's rows and keys can see (the far
//   side of the causal diagonal, beyond a window) are skipped, not
//   masked; the per-element mask runs only on tiles some pair of which is
//   hidden.
// float32 inputs have no tensor-core path with float32 products (TF32
// would change the numbers), so the float32 kernels use FMAs on the CUDA
// cores.
// Head dims: instances for 16, 32, 64 and 128. At D = 16 the bf16
// kernels' tiles are one 16-column box with the 32-byte swizzle, S and dP
// a single k16 step, and dS K, P^T dO and dS^T Q m64n16k16 products; the
// float32 kernels give each thread one output column. The wrapper
// (../attention.py) zero-pads any other head dim up to 128 to the next
// of these and slices dq, dk and dv back.

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// ---- bf16: TMA, wgmma, warp-specialised consumers -----------------------

constexpr int BWD_THREADS = 384;    // consumer warpgroups 0, 1; producer 2
constexpr int BWD_CONSUMERS = 256;  // threads of the consumer warpgroups
constexpr int DQ_STAGES = 3;        // dq: depth of the K/V ring
constexpr int DKV_STAGES = 2;       // dkv: depth of the q-tile ring
constexpr int DQ_BM = 128;          // dq: query rows per item
constexpr int DQ_BN = 64;           // dq: keys per K/V tile
constexpr int DKV_BN = 128;         // dkv: keys per item
constexpr int DKV_BM = 64;          // dkv: query rows per q tile
// registers a thread after setmaxnreg: the launch gives each of the 384
// threads 168 (65536 / 384, rounded down to 8), and the warpgroups' sum
// stays 168 * 384 = 24 * 128 + 240 * 256
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;

using DqRing = Ring<DQ_STAGES>;    // dq's K/V tiles
using DkvRing = Ring<DKV_STAGES>;  // dkv's q tiles
using ItemRing = Ring<2>;          // the tiles an item keeps

// Tiles as Tile<D>::BOXES column boxes of [rows][COLS] bf16 (hopper.cuh);
// every box is a multiple of 8 rows, so all start on the swizzle's period.
template <int D>
struct DqSmem {
  using Tl = Tile<D>;
  __nv_bfloat16 q[2][Tl::BOXES][DQ_BM * Tl::COLS];
  __nv_bfloat16 dout[2][Tl::BOXES][DQ_BM * Tl::COLS];
  __nv_bfloat16 k[DQ_STAGES][Tl::BOXES][DQ_BN * Tl::COLS];
  __nv_bfloat16 v[DQ_STAGES][Tl::BOXES][DQ_BN * Tl::COLS];
  uint64_t full_q[2], empty_q[2], full_k[DQ_STAGES], full_v[DQ_STAGES];
  uint64_t empty_k[DQ_STAGES], empty_v[DQ_STAGES];
};

template <int D>
struct DkvSmem {
  using Tl = Tile<D>;
  __nv_bfloat16 k[2][Tl::BOXES][DKV_BN * Tl::COLS];
  __nv_bfloat16 v[2][Tl::BOXES][DKV_BN * Tl::COLS];
  __nv_bfloat16 q[DKV_STAGES][Tl::BOXES][DKV_BM * Tl::COLS];
  __nv_bfloat16 dout[DKV_STAGES][Tl::BOXES][DKV_BM * Tl::COLS];
  float lse[DKV_STAGES][DKV_BM];  // the q tile's rows (TMA: 128-aligned)
  float delta[DKV_STAGES][DKV_BM];
  uint64_t full_kv[2], empty_kv[2], full_q[DKV_STAGES], empty_q[DKV_STAGES];
};

// the two consumer warpgroups (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  __syncwarp();
  asm volatile("bar.sync 1, %0;\n" ::"n"(BWD_CONSUMERS) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// An accumulator (N float32 a thread, N / 4 chunks of 8 columns) rounded
// to bf16 as the A fragments of a register-sourced product: k step kk
// takes chunks 2 kk and 2 kk + 1.
template <int N>
__device__ __forceinline__ void pack_frags(const float (&x)[N],
                                           uint32_t (&f)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    f[j / 2][(j % 2) * 2] = pack_bf16(x[4 * j], x[4 * j + 1]);  // row g
    f[j / 2][(j % 2) * 2 + 1] =
        pack_bf16(x[4 * j + 2], x[4 * j + 3]);  // row g + 8
  }
}

// ---- dq ----------------------------------------------------------------

// One work item of the host's list: query head bh, its DQ_BM-row q tile at
// q0, and the keys [lo, hi) its rows can see (lo a multiple of DQ_BN).
// The list is int32: G + 1 offsets (block b takes items offsets[b] to
// offsets[b + 1] - 1, in that order), then four ints an item.
struct QItem {
  int bh, q0, lo, hi;
};

__device__ __forceinline__ QItem q_item(const int* __restrict__ items,
                                        int i) {
  const int* p = items + 4 * i;
  return {p[0], p[1], p[2], p[3]};
}

// One consumer warpgroup of dq: 64 query rows, their positions, lse (in
// log2 units) and delta', and the products of one K/V tile.
template <int D>
struct DqRows {
  static constexpr int NS = DQ_BN / 2;  // S and dP accumulators a thread
  static constexpr int NO = D / 2;      // dQ accumulators a thread
  using Tl = Tile<D>;
  DqSmem<D>& sm;
  int wg, qst, qpos0, qpos1, first, last, t_k, causal, window;
  float scale_log2, lse0, lse1, del0, del1;

  // S = Q K^T and dP = dO V^T of the tile in `stage`, started, not
  // committed; k step kk: 16 columns, 32 bytes a step into box
  // kk / KSTEPS
  __device__ __forceinline__ void start_s_dp(float (&s)[NS], float (&dp)[NS],
                                             int stage) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk / Tl::KSTEPS, col = (kk % Tl::KSTEPS) * 16;
      const int at = wg * 64 * Tl::COLS + col;
      WgmmaSS<DQ_BN>::run(s, k_desc<D>(sm.q[qst][box] + at),
                          k_desc<D>(sm.k[stage][box] + col), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk / Tl::KSTEPS, col = (kk % Tl::KSTEPS) * 16;
      const int at = wg * 64 * Tl::COLS + col;
      WgmmaSS<DQ_BN>::run(dp, k_desc<D>(sm.dout[qst][box] + at),
                          k_desc<D>(sm.v[stage][box] + col), kk > 0);
    }
  }

  // dQ += dS K of the tile in `stage`, started, not committed. K is the
  // MN-major B (the transpose bit): keys 16 kk .. 16 kk + 15 are 16 rows
  // into each box, the next COLS columns one box (DQ_BN rows) on.
  __device__ __forceinline__ void start_dq(float (&dq)[NO],
                                           const uint32_t (&dsf)[NS / 8][4],
                                           int stage) {
#pragma unroll
    for (int kk = 0; kk < DQ_BN / 16; ++kk)
      WgmmaRS<D>::run(dq, dsf[kk],
                      mn_desc<D>(sm.k[stage][0] + kk * 16 * Tl::COLS,
                                 DQ_BN * Tl::ROW_BYTES));
  }

  // dS = P (dP - delta') in place of dP, with P = 2^(S scale log2 e -
  // lse log2 e), 0 where masked, for the tile of keys at k0
  __device__ __forceinline__ void grad(const float (&s)[NS], float (&dp)[NS],
                                       int k0, int tig) const {
    const bool whole = k0 + DQ_BN <= t_k &&
                       (!causal || (k0 + DQ_BN - 1 <= first &&
                                    (window <= 0 || k0 > last - window)));
#pragma unroll
    for (int j = 0; j < DQ_BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + j * 8 + 2 * tig + e;
        const bool v0 = whole || visible(qpos0, kpos, t_k, causal, window);
        const bool v1 = whole || visible(qpos1, kpos, t_k, causal, window);
        const float p0 =
            v0 ? exp2_approx(fmaf(s[4 * j + e], scale_log2, -lse0)) : 0.f;
        const float p1 =
            v1 ? exp2_approx(fmaf(s[4 * j + 2 + e], scale_log2, -lse1)) : 0.f;
        dp[4 * j + e] = p0 * (dp[4 * j + e] - del0);
        dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - del1);
      }
    }
  }
};

// One dq work item for the two consumer warpgroups. Rows past Tq hold
// zeros and lse = delta' = 0, so their dS is 0 with no mask.
template <int D>
__device__ __forceinline__ void dq_consume(
    DqSmem<D>& sm, int qst, __nv_bfloat16* __restrict__ dq,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const QItem& it, int t_q, int t_k, int causal, float scale,
    float scale_log2, int window, DqRing& ring) {
  using Rows = DqRows<D>;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int offset = causal ? t_k - t_q : 0;
  const int row0 = it.q0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
  const int wg_row = it.q0 + wg * 64;
  const size_t at = (size_t)it.bh * t_q;
  Rows rows{sm,
                  wg,
                  qst,
                  row0 + offset,
                  row1 + offset,
                  wg_row + offset,
                  min(wg_row + 64, t_q) - 1 + offset,
                  t_k,
                  causal,
                  window,
                  scale_log2,
                  row0 < t_q ? lse[at + row0] * LOG2E : 0.f,
                  row1 < t_q ? lse[at + row1] * LOG2E : 0.f,
                  row0 < t_q ? delta[at + row0] : 0.f,
                  row1 < t_q ? delta[at + row1] : 0.f};
  // the item's key tiles j < n; this warpgroup's rows see only [jlo, jhi)
  const int n = (it.hi - it.lo + DQ_BN - 1) / DQ_BN;
  int jlo = 0, jhi = n;
  if (rows.last < rows.first) {
    jhi = 0;  // no real row
  } else if (causal) {
    jhi = min(n, (rows.last - it.lo) / DQ_BN + 1);
    if (window > 0) jlo = max(0, (rows.first - window + 1 - it.lo) / DQ_BN);
  }
  jlo = min(jlo, jhi);
  auto skip = [&]() {  // a tile the warpgroup's rows cannot see
    mbar_wait(&sm.full_k[ring.stage], ring.phase);
    mbar_wait(&sm.full_v[ring.stage], ring.phase);
    release(&sm.empty_k[ring.stage], lane);
    release(&sm.empty_v[ring.stage], lane);
    ring.advance();
  };

  float acc[Rows::NO];
#pragma unroll
  for (int i = 0; i < Rows::NO; ++i) acc[i] = 0.f;
  for (int j = 0; j < jlo; ++j) skip();
  if (jlo < jhi) {
    float s[Rows::NS], dp[Rows::NS];
    uint32_t dsf[Rows::NS / 8][4];
    int k0 = it.lo + jlo * DQ_BN;
    DqRing cur = ring;  // tile j - 1, whose dS K is pending
    mbar_wait(&sm.full_k[cur.stage], cur.phase);
    mbar_wait(&sm.full_v[cur.stage], cur.phase);
    wgmma_fence();
    rows.start_s_dp(s, dp, cur.stage);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    release(&sm.empty_v[cur.stage], lane);
    rows.grad(s, dp, k0, tig);
    pack_frags(dp, dsf);
    for (int j = jlo + 1; j < jhi; ++j) {
      DqRing next = cur;
      next.advance();
      k0 += DQ_BN;
      mbar_wait(&sm.full_k[next.stage], next.phase);
      mbar_wait(&sm.full_v[next.stage], next.phase);
      wgmma_fence();
      rows.start_s_dp(s, dp, next.stage);
      wgmma_commit();
      rows.start_dq(acc, dsf, cur.stage);
      wgmma_commit();
      wgmma_wait<1>();  // S and dP are done; dS K may still run
      fence_regs(s);
      fence_regs(dp);
      release(&sm.empty_v[next.stage], lane);
      rows.grad(s, dp, k0, tig);
      wgmma_wait<0>();
      fence_regs(acc);
      release(&sm.empty_k[cur.stage], lane);
      pack_frags(dp, dsf);
      cur = next;
    }
    wgmma_fence();
    rows.start_dq(acc, dsf, cur.stage);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release(&sm.empty_k[cur.stage], lane);
    ring = cur;
    ring.advance();
  }
  for (int j = jhi; j < n; ++j) skip();
  release(&sm.empty_q[qst], lane);  // Q and dO may be refilled

  __nv_bfloat16* op = dq + at * D;
  if (row0 < t_q) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + (size_t)row0 * D + j * 8 +
                                         2 * tig) =
          __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
  }
  if (row1 < t_q) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + (size_t)row1 * D + j * 8 +
                                         2 * tig) =
          __floats2bfloat162_rn(acc[4 * j + 2] * scale,
                                acc[4 * j + 3] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      __nv_bfloat16* __restrict__ dq,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ work, int heads, int kv_heads,
                      int t_q, int t_k, int causal, float scale, int window) {
  using Tl = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  DqSmem<D>& sm = aligned_smem<DqSmem<D>>(smem_raw);
  const int begin = work[blockIdx.x], end = work[blockIdx.x + 1];
  const int* items = work + gridDim.x + 1;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.full_q[i], 1);
      mbar_init(&sm.empty_q[i], BWD_CONSUMERS / 32);  // one per warp
    }
#pragma unroll
    for (int i = 0; i < DQ_STAGES; ++i) {
      mbar_init(&sm.full_k[i], 1);
      mbar_init(&sm.full_v[i], 1);
      mbar_init(&sm.empty_k[i], BWD_CONSUMERS / 32);
      mbar_init(&sm.empty_v[i], BWD_CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= BWD_CONSUMERS) {
    // producer warpgroup: one thread starts every load
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == BWD_CONSUMERS) {
      constexpr uint32_t ROWS_BYTES = DQ_BM * D * sizeof(__nv_bfloat16);
      constexpr uint32_t TILE_BYTES = DQ_BN * D * sizeof(__nv_bfloat16);
      ItemRing qr;
      DqRing ring;
      for (int i = begin; i < end; ++i) {
        const QItem it = q_item(items, i);
        const int kvh = (it.bh / heads) * kv_heads +
                        (it.bh % heads) / (heads / kv_heads);
        mbar_wait(&sm.empty_q[qr.stage], qr.phase ^ 1);
        mbar_expect_tx(&sm.full_q[qr.stage], 2 * ROWS_BYTES);
#pragma unroll
        for (int h = 0; h < Tl::BOXES; ++h) {
          tma_load_3d(sm.q[qr.stage][h], &q_map, &sm.full_q[qr.stage],
                      h * Tl::COLS, it.q0, it.bh);
          tma_load_3d(sm.dout[qr.stage][h], &do_map, &sm.full_q[qr.stage],
                      h * Tl::COLS, it.q0, it.bh);
        }
        qr.advance();
        for (int k0 = it.lo; k0 < it.hi; k0 += DQ_BN) {
          mbar_wait(&sm.empty_k[ring.stage], ring.phase ^ 1);
          mbar_expect_tx(&sm.full_k[ring.stage], TILE_BYTES);
#pragma unroll
          for (int h = 0; h < Tl::BOXES; ++h)
            tma_load_3d(sm.k[ring.stage][h], &k_map, &sm.full_k[ring.stage],
                        h * Tl::COLS, k0, kvh);
          mbar_wait(&sm.empty_v[ring.stage], ring.phase ^ 1);
          mbar_expect_tx(&sm.full_v[ring.stage], TILE_BYTES);
#pragma unroll
          for (int h = 0; h < Tl::BOXES; ++h)
            tma_load_3d(sm.v[ring.stage][h], &v_map, &sm.full_v[ring.stage],
                        h * Tl::COLS, k0, kvh);
          ring.advance();
        }
      }
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    ItemRing qr;
    DqRing ring;
    for (int i = begin; i < end; ++i) {
      mbar_wait(&sm.full_q[qr.stage], qr.phase);
      dq_consume<D>(sm, qr.stage, dq, lse, delta, q_item(items, i), t_q, t_k,
                    causal, scale, scale * LOG2E, window, ring);
      qr.advance();
    }
  }
}

// ---- dk / dv -----------------------------------------------------------

// One work item of the host's list: kv head bkv (b * Hkv + kv head), its
// DKV_BN-key tile at k0, query head r of its group, and the query rows
// [lo, hi) that can see the tile (lo a multiple of DKV_BM; empty when
// hi <= lo). The list: G + 1 offsets, then five ints an item.
struct KvItem {
  int bkv, k0, r, lo, hi;
};

__device__ __forceinline__ KvItem kv_item(const int* __restrict__ items,
                                          int i) {
  const int* p = items + 5 * i;
  return {p[0], p[1], p[2], p[3], p[4]};
}

// One consumer warpgroup of dkv: 64 keys of the item's tile and the
// products of one q tile. Its accumulators are transposed against dq's:
// rows are keys, columns query rows, so lse and delta' are per column.
template <int D>
struct DkvKeys {
  static constexpr int NS = DKV_BM / 2;  // S^T and dP^T accumulators
  static constexpr int NO = D / 2;       // dK, dV accumulators a thread
  using Tl = Tile<D>;
  DkvSmem<D>& sm;
  int wg, kst, key0, key1, first, t_q, t_k, offset, causal, window;
  float scale_log2;

  // S^T = K Q^T and dP^T = V dO^T of the q tile in `stage`, started, not
  // committed; K and V are this warpgroup's 64 rows of the kept tiles
  __device__ __forceinline__ void start_s_dp(float (&s)[NS], float (&dp)[NS],
                                             int stage) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk / Tl::KSTEPS, col = (kk % Tl::KSTEPS) * 16;
      const int at = wg * 64 * Tl::COLS + col;
      WgmmaSS<DKV_BM>::run(s, k_desc<D>(sm.k[kst][box] + at),
                           k_desc<D>(sm.q[stage][box] + col), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk / Tl::KSTEPS, col = (kk % Tl::KSTEPS) * 16;
      const int at = wg * 64 * Tl::COLS + col;
      WgmmaSS<DKV_BM>::run(dp, k_desc<D>(sm.v[kst][box] + at),
                           k_desc<D>(sm.dout[stage][box] + col), kk > 0);
    }
  }

  // acc += A B with B = the q tile `tile` of `stage` read MN-major (query
  // rows 16 kk .. 16 kk + 15 are 16 rows into each box), started, not
  // committed
  __device__ __forceinline__ static void start_rs(
      float (&acc)[NO], const uint32_t (&a)[NS / 8][4],
      const __nv_bfloat16* tile) {
#pragma unroll
    for (int kk = 0; kk < DKV_BM / 16; ++kk)
      WgmmaRS<D>::run(acc, a[kk],
                      mn_desc<D>(tile + kk * 16 * Tl::COLS,
                                 DKV_BM * Tl::ROW_BYTES));
  }

  // P^T = 2^(S^T scale log2 e - lse log2 e) in place of S^T, 0 where
  // masked, for the q tile whose rows start at qr0. Rows past Tq arrive
  // as zeros (S = 0) with lse = 0: masked here.
  __device__ __forceinline__ void probs(float (&s)[NS], int qr0, int stage,
                                        int tig) const {
    const bool whole =
        qr0 + DKV_BM <= t_q && first + 64 <= t_k &&
        (!causal || (first + 63 <= qr0 + offset &&
                     (window <= 0 || qr0 + DKV_BM - 1 + offset - window <
                                         first)));
#pragma unroll
    for (int j = 0; j < DKV_BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * tig + e, q = qr0 + c;
        const float l = sm.lse[stage][c] * LOG2E;
        const bool v0 =
            whole || (q < t_q && visible(q + offset, key0, t_k, causal, window));
        const bool v1 =
            whole || (q < t_q && visible(q + offset, key1, t_k, causal, window));
        s[4 * j + e] = v0 ? exp2_approx(fmaf(s[4 * j + e], scale_log2, -l)) : 0.f;
        s[4 * j + 2 + e] =
            v1 ? exp2_approx(fmaf(s[4 * j + 2 + e], scale_log2, -l)) : 0.f;
      }
    }
  }

  // dS^T = P^T (dP^T - delta') in place of dP^T
  __device__ __forceinline__ void dscores(const float (&p)[NS],
                                          float (&dp)[NS], int stage,
                                          int tig) const {
#pragma unroll
    for (int j = 0; j < DKV_BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = sm.delta[stage][j * 8 + 2 * tig + e];
        dp[4 * j + e] = p[4 * j + e] * (dp[4 * j + e] - d);
        dp[4 * j + 2 + e] = p[4 * j + 2 + e] * (dp[4 * j + 2 + e] - d);
      }
    }
  }
};

// x = the float32 partial of earlier items (scratch, the accumulators'
// layout: float4 i of consumer thread t at i * 256 + t) + x
template <int N>
__device__ __forceinline__ void add_partial(float (&x)[N],
                                            const float* __restrict__ p) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(p) +
                            i * BWD_CONSUMERS + threadIdx.x);
    x[4 * i] = a.x + x[4 * i];
    x[4 * i + 1] = a.y + x[4 * i + 1];
    x[4 * i + 2] = a.z + x[4 * i + 2];
    x[4 * i + 3] = a.w + x[4 * i + 3];
  }
}

template <int N>
__device__ __forceinline__ void store_partial(const float (&x)[N],
                                              float* __restrict__ p) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    __stcg(reinterpret_cast<float4*>(p) + i * BWD_CONSUMERS + threadIdx.x,
           make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]));
}

// One dkv work item for the two consumer warpgroups, its sum into the
// group's, and (last of the group) dk and dv.
template <int D>
__device__ __forceinline__ void dkv_consume(
    DkvSmem<D>& sm, int kst, const KvItem& it, int reps,
    __nv_bfloat16* __restrict__ dk_out, __nv_bfloat16* __restrict__ dv_out,
    float* __restrict__ scratch, int* __restrict__ counters, int t_q,
    int t_k, int causal, float scale, float scale_log2, int window,
    DkvRing& ring) {
  using Keys = DkvKeys<D>;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int offset = causal ? t_k - t_q : 0;
  const int first = it.k0 + wg * 64;  // the warpgroup's first key
  const int key0 = first + warp * 16 + g, key1 = key0 + 8;
  Keys keys{sm,     wg,     kst,    key0,   key1,      first,
                  t_q,    t_k,    offset, causal, window,    scale_log2};
  // the item's q tiles s < n; this warpgroup's keys are seen only by
  // [slo, shi)
  const int n = it.hi > it.lo ? (it.hi - it.lo + DKV_BM - 1) / DKV_BM : 0;
  int slo = 0, shi = n;
  if (first >= t_k) {
    shi = 0;  // no real key
  } else if (causal) {
    slo = max(0, (first - offset - it.lo) / DKV_BM);
    if (window > 0) {
      const int end = min(first + 63, t_k - 1) + window - offset - it.lo;
      shi = end <= 0 ? 0 : min(n, (end + DKV_BM - 1) / DKV_BM);
    }
  }
  slo = min(slo, shi);
  auto skip = [&]() {  // a q tile no row of which sees these keys
    mbar_wait(&sm.full_q[ring.stage], ring.phase);
    release(&sm.empty_q[ring.stage], lane);
    ring.advance();
  };

  float dk[Keys::NO], dv[Keys::NO];
#pragma unroll
  for (int i = 0; i < Keys::NO; ++i) dk[i] = dv[i] = 0.f;
  for (int s = 0; s < slo; ++s) skip();
  for (int s = slo; s < shi; ++s) {
    const int st = ring.stage;
    float sp[Keys::NS], dp[Keys::NS];
    uint32_t pf[Keys::NS / 8][4], dsf[Keys::NS / 8][4];
    mbar_wait(&sm.full_q[st], ring.phase);
    wgmma_fence();
    keys.start_s_dp(sp, dp, st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sp);
    fence_regs(dp);
    keys.probs(sp, it.lo + s * DKV_BM, st, tig);
    pack_frags(sp, pf);
    wgmma_fence();
    Keys::start_rs(dv, pf, sm.dout[st][0]);  // dV += P^T dO
    wgmma_commit();
    keys.dscores(sp, dp, st, tig);  // while dV runs
    pack_frags(dp, dsf);
    wgmma_fence();
    Keys::start_rs(dk, dsf, sm.q[st][0]);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    release(&sm.empty_q[st], lane);
    ring.advance();
  }
  for (int s = shi; s < n; ++s) skip();
  release(&sm.empty_kv[kst], lane);  // K and V may be refilled

  if (reps > 1) {
    // the group's sum, in the order r = 0, 1, ...: wait for item r - 1,
    // add to its partial, pass the tile on to item r + 1
    const int tile = it.bkv * ((t_k + DKV_BN - 1) / DKV_BN) + it.k0 / DKV_BN;
    float* part_k = scratch + (size_t)tile * 2 * BWD_CONSUMERS * Keys::NO;
    float* part_v = part_k + BWD_CONSUMERS * Keys::NO;
    int* count = counters + tile;
    if (it.r > 0) {
      if (threadIdx.x == 0)
        while (ld_acquire(count) < it.r) __nanosleep(32);
      consumers_sync();
      add_partial(dk, part_k);
      add_partial(dv, part_v);
    }
    if (it.r + 1 < reps) {
      store_partial(dk, part_k);
      store_partial(dv, part_v);
      __threadfence();
      consumers_sync();
      if (threadIdx.x == 0) st_release(count, it.r + 1);
      return;
    }
  }
  const size_t base = (size_t)it.bkv * t_k * D;
  if (key0 < t_k) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = base + (size_t)key0 * D + j * 8 + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(dk_out + at) =
          __floats2bfloat162_rn(dk[4 * j] * scale, dk[4 * j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + at) =
          __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
    }
  }
  if (key1 < t_k) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = base + (size_t)key1 * D + j * 8 + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(dk_out + at) = __floats2bfloat162_rn(
          dk[4 * j + 2] * scale, dk[4 * j + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + at) =
          __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const __grid_constant__ CUtensorMap lse_map,
                       const __grid_constant__ CUtensorMap delta_map,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv,
                       float* __restrict__ scratch,
                       int* __restrict__ counters,
                       const int* __restrict__ work, int heads, int kv_heads,
                       int t_q, int t_k, int causal, float scale, int window) {
  using Tl = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<D>& sm = aligned_smem<DkvSmem<D>>(smem_raw);
  const int begin = work[blockIdx.x], end = work[blockIdx.x + 1];
  const int* items = work + gridDim.x + 1;
  const int reps = heads / kv_heads;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.full_kv[i], 1);
      mbar_init(&sm.empty_kv[i], BWD_CONSUMERS / 32);  // one per warp
    }
#pragma unroll
    for (int i = 0; i < DKV_STAGES; ++i) {
      mbar_init(&sm.full_q[i], 1);
      mbar_init(&sm.empty_q[i], BWD_CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= BWD_CONSUMERS) {
    // producer warpgroup: one thread starts every load. lse and delta'
    // rows are read through 1-D maps over [B*H, Tq rounded up to 4]: a q
    // tile's box then starts 16-byte aligned
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == BWD_CONSUMERS) {
      constexpr uint32_t KV_BYTES = DKV_BN * D * sizeof(__nv_bfloat16);
      constexpr uint32_t Q_BYTES =
          2 * DKV_BM * D * sizeof(__nv_bfloat16) + 2 * DKV_BM * sizeof(float);
      const int stride = (t_q + 3) / 4 * 4;
      ItemRing kr;
      DkvRing ring;
      for (int i = begin; i < end; ++i) {
        const KvItem it = kv_item(items, i);
        const int bh = (it.bkv / kv_heads) * heads +
                       (it.bkv % kv_heads) * reps + it.r;
        mbar_wait(&sm.empty_kv[kr.stage], kr.phase ^ 1);
        mbar_expect_tx(&sm.full_kv[kr.stage], 2 * KV_BYTES);
#pragma unroll
        for (int h = 0; h < Tl::BOXES; ++h) {
          tma_load_3d(sm.k[kr.stage][h], &k_map, &sm.full_kv[kr.stage],
                      h * Tl::COLS, it.k0, it.bkv);
          tma_load_3d(sm.v[kr.stage][h], &v_map, &sm.full_kv[kr.stage],
                      h * Tl::COLS, it.k0, it.bkv);
        }
        kr.advance();
        for (int qr0 = it.lo; qr0 < it.hi; qr0 += DKV_BM) {
          uint64_t* full = &sm.full_q[ring.stage];
          mbar_wait(&sm.empty_q[ring.stage], ring.phase ^ 1);
          mbar_expect_tx(full, Q_BYTES);
#pragma unroll
          for (int h = 0; h < Tl::BOXES; ++h) {
            tma_load_3d(sm.q[ring.stage][h], &q_map, full, h * Tl::COLS, qr0,
                        bh);
            tma_load_3d(sm.dout[ring.stage][h], &do_map, full, h * Tl::COLS,
                        qr0, bh);
          }
          tma_load_1d(sm.lse[ring.stage], &lse_map, full, bh * stride + qr0);
          tma_load_1d(sm.delta[ring.stage], &delta_map, full,
                      bh * stride + qr0);
          ring.advance();
        }
      }
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    ItemRing kr;
    DkvRing ring;
    for (int i = begin; i < end; ++i) {
      mbar_wait(&sm.full_kv[kr.stage], kr.phase);
      dkv_consume<D>(sm, kr.stage, kv_item(items, i), reps, dk, dv, scratch,
                     counters, t_q, t_k, causal, scale, scale * LOG2E, window,
                     ring);
      kr.advance();
    }
  }
}

// Query rows [lo, hi) of a head that can see any key of the tile at k0:
// the float32 dkv loop bounds (rows outside them would give P = 0).
struct RowRange {
  int lo, hi;
};

__device__ __forceinline__ RowRange row_range(int k0, int t_q, int t_k,
                                              int causal, int window) {
  RowRange r{0, t_q};
  if (causal) {
    const int offset = t_k - t_q;
    const int k_last = min(k0 + BK, t_k) - 1;
    r.lo = max(0, k0 - offset);
    if (window > 0) r.hi = min(t_q, k_last + window - offset);
  }
  r.lo -= r.lo % BQ;  // q tiles are aligned to their height
  return r;
}

// ---- float32: CUDA-core FMAs -----------------------------------------
//
// A 16 x 16 grid of threads; thread (ty, tx) owns rows ty + 16 i (i < 4)
// and, of a 64-wide score tile, columns tx + 16 j, and of a D-wide output
// row, columns tx + 16 c. Tiles are stored transposed with padded leading
// dims so that shared-memory reads are conflict-free or broadcasts.

// Copy rows [row0, row0 + 64) of a [rows, D] float32 matrix into a
// transposed [D][ld] tile; rows past n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_t(float* dst, int ld,
                                            const float* src, int row0,
                                            int n_rows) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += FMA_THREADS) {
    const int r = idx / D, d = idx % D;
    dst[d * ld + r] = row0 + r < n_rows ? src[(size_t)(row0 + r) * D + d] : 0.f;
  }
}

template <int D>
constexpr size_t dq_f32_smem_floats() {
  return 4 * (size_t)D * LDQ  // q, dO, K, V tiles, transposed
         + (size_t)BK * LDQ;  // dS tile, transposed [key][row]
}

template <int D>
__global__ void __launch_bounds__(FMA_THREADS)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int heads, int kv_heads, int t_q, int t_k, int causal,
                     float scale, int window) {
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [D][LDQ]
  float* dos = qs + D * LDQ;    // [D][LDQ]
  float* ks = dos + D * LDQ;    // [D][LDK]
  float* vs = ks + D * LDK;     // [D][LDK]
  float* dss = vs + D * LDK;    // [BK][LDQ]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = (bh / heads) * kv_heads + (bh % heads) / (heads / kv_heads);
  const float* kp = k + (size_t)kvh * t_k * D;
  const float* vp = v + (size_t)kvh * t_k * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile_t<D>(qs, LDQ, q + (size_t)bh * t_q * D, q0, t_q);
  load_tile_t<D>(dos, LDQ, dout + (size_t)bh * t_q * D, q0, t_q);
  const KeyRange range = key_range(q0, t_q, t_k, causal, window);
  float l[4], dl[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    l[i] = r < t_q ? lse[(size_t)bh * t_q + r] : 0.f;
    dl[i] = r < t_q ? delta[(size_t)bh * t_q + r] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = range.lo; k0 < range.hi; k0 += BK) {
    __syncthreads();  // previous tile's readers are done
    load_tile_t<D>(ks, LDK, kp, k0, t_k);
    load_tile_t<D>(vs, LDK, vp, k0, t_k);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], da[4], b[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[d * LDQ + ty + 16 * i];
        da[i] = dos[d * LDQ + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = ks[d * LDK + tx + 16 * j];
        vb[j] = vs[d * LDK + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = range.q_first + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool vis = visible(qpos, k0 + tx + 16 * j, t_k, causal, window);
        const float p = vis ? expf(s[i][j] * scale - l[i]) : 0.f;
        dss[(tx + 16 * j) * LDQ + ty + 16 * i] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], w[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dss[kk * LDQ + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < DC; ++c) w[c] = ks[(tx + 16 * c) * LDK + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(a[i], w[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= t_q) continue;
    float* op = dq + ((size_t)bh * t_q + r) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) op[tx + 16 * c] = acc[i][c] * scale;
  }
}

template <int D>
constexpr size_t dkv_f32_smem_floats() {
  return 4 * (size_t)D * LDK    // K, V, q, dO tiles, transposed
         + 2 * (size_t)BQ * LDK  // P and dS tiles, [row][key]
         + 2 * BQ;               // lse, delta' of the q tile
}

template <int D>
__global__ void __launch_bounds__(FMA_THREADS)
    flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int heads, int kv_heads, int t_q,
                      int t_k, int causal, float scale, int window) {
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* ks = smem;            // [D][LDK]
  float* vs = ks + D * LDK;    // [D][LDK]
  float* qs = vs + D * LDK;    // [D][LDK] (64 query rows)
  float* dos = qs + D * LDK;   // [D][LDK]
  float* ps = dos + D * LDK;   // [BQ][LDK]
  float* dss = ps + BQ * LDK;  // [BQ][LDK]
  float* lt = dss + BQ * LDK;  // [BQ]
  float* dt = lt + BQ;         // [BQ]

  const int bkv = blockIdx.y;
  const int reps = heads / kv_heads;
  const int first_bh = (bkv / kv_heads) * heads + (bkv % kv_heads) * reps;
  const int k0 = blockIdx.x * BK;
  const int offset = causal ? t_k - t_q : 0;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const RowRange rows = row_range(k0, t_q, t_k, causal, window);

  load_tile_t<D>(ks, LDK, k + (size_t)bkv * t_k * D, k0, t_k);
  load_tile_t<D>(vs, LDK, v + (size_t)bkv * t_k * D, k0, t_k);
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int r = 0; r < reps; ++r) {
    const int bh = first_bh + r;
    for (int qr0 = rows.lo; qr0 < rows.hi; qr0 += BQ) {
      __syncthreads();  // previous tile's readers are done
      load_tile_t<D>(qs, LDK, q + (size_t)bh * t_q * D, qr0, t_q);
      load_tile_t<D>(dos, LDK, dout + (size_t)bh * t_q * D, qr0, t_q);
      for (int c = tid; c < BQ; c += FMA_THREADS) {
        const bool in = qr0 + c < t_q;
        lt[c] = in ? lse[(size_t)bh * t_q + qr0 + c] : 0.f;
        dt[c] = in ? delta[(size_t)bh * t_q + qr0 + c] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: keys ty + 16 i, query rows tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[4], va[4], b[4], db[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = ks[d * LDK + ty + 16 * i];
          va[i] = vs[d * LDK + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = qs[d * LDK + tx + 16 * j];
          db[j] = dos[d * LDK + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i], b[j], s[i][j]);
            dp[i][j] = fmaf(va[i], db[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, qi = qr0 + c;
          const bool vis =
              qi < t_q && visible(qi + offset, kpos, t_k, causal, window);
          const float p = vis ? expf(s[i][j] * scale - lt[c]) : 0.f;
          ps[c * LDK + ty + 16 * i] = p;
          dss[c * LDK + ty + 16 * i] = p * (dp[i][j] - dt[c]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c2 = 0; c2 < BQ; ++c2) {
        float p[4], ds[4], wo[DC], wq[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = ps[c2 * LDK + ty + 16 * i];
          ds[i] = dss[c2 * LDK + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          wo[c] = dos[(tx + 16 * c) * LDK + c2];
          wq[c] = qs[(tx + 16 * c) * LDK + c2];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv_acc[i][c] = fmaf(p[i], wo[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds[i], wq[c], dk_acc[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= t_k) continue;
    const size_t at = ((size_t)bkv * t_k + kpos) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[at + tx + 16 * c] = dk_acc[i][c] * scale;
      dv[at + tx + 16 * c] = dv_acc[i][c];
    }
  }
}

// ---- launches ----------------------------------------------------------

template <int D>
int launch_dq(int is_bf16, const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta, void* dq,
              const int* work, int blocks, int batch, int heads, int kv_heads,
              int t_q, int t_k, int causal, float scale, int window,
              cudaStream_t stream) {
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    if (work == nullptr || blocks <= 0) return (int)cudaErrorInvalidValue;
    CUtensorMap q_map, do_map, k_map, v_map;
    if ((err = tensor_map(&q_map, q, D, t_q, batch * heads, DQ_BM)) ||
        (err = tensor_map(&do_map, dout, D, t_q, batch * heads, DQ_BM)) ||
        (err = tensor_map(&k_map, k, D, t_k, batch * kv_heads, DQ_BN)) ||
        (err = tensor_map(&v_map, v, D, t_k, batch * kv_heads, DQ_BN)))
      return (int)err;
    const size_t smem = smem_bytes<DqSmem<D>>();
    err = allow_smem(flash_bwd_dq_bf16<D>, smem);
    if (err != cudaSuccess) return (int)err;
    // persistent: the work list is dealt to `blocks` blocks, one an SM
    flash_bwd_dq_bf16<D><<<blocks, BWD_THREADS, smem, stream>>>(
        q_map, do_map, k_map, v_map, static_cast<T*>(dq), lse, delta, work,
        heads, kv_heads, t_q, t_k, causal, scale, window);
  } else {
    const dim3 grid((t_q + BQ - 1) / BQ, batch * heads);
    const size_t smem = dq_f32_smem_floats<D>() * sizeof(float);
    err = allow_smem(flash_bwd_dq_f32<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_f32<D><<<grid, FMA_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), heads, kv_heads, t_q, t_k, causal,
        scale, window);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(int is_bf16, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, const int* work, float* scratch,
               int* counters, int blocks, int batch, int heads, int kv_heads,
               int t_q, int t_k, int causal, float scale, int window,
               cudaStream_t stream) {
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    if (work == nullptr || blocks <= 0 ||
        (heads > kv_heads && (scratch == nullptr || counters == nullptr)))
      return (int)cudaErrorInvalidValue;
    // lse and delta' as [B*H, Tq rounded up to 4] (padded by the caller)
    const size_t rows = (size_t)batch * heads * ((t_q + 3) / 4 * 4);
    CUtensorMap k_map, v_map, q_map, do_map, lse_map, delta_map;
    if ((err = tensor_map(&k_map, k, D, t_k, batch * kv_heads, DKV_BN)) ||
        (err = tensor_map(&v_map, v, D, t_k, batch * kv_heads, DKV_BN)) ||
        (err = tensor_map(&q_map, q, D, t_q, batch * heads, DKV_BM)) ||
        (err = tensor_map(&do_map, dout, D, t_q, batch * heads, DKV_BM)) ||
        (err = tensor_map_f32(&lse_map, lse, rows, DKV_BM)) ||
        (err = tensor_map_f32(&delta_map, delta, rows, DKV_BM)))
      return (int)err;
    const size_t smem = smem_bytes<DkvSmem<D>>();
    err = allow_smem(flash_bwd_dkv_bf16<D>, smem);
    if (err != cudaSuccess) return (int)err;
    // persistent, at most one block an SM: the group's ordered sum needs
    // every block resident (see the note at the top)
    flash_bwd_dkv_bf16<D><<<blocks, BWD_THREADS, smem, stream>>>(
        k_map, v_map, q_map, do_map, lse_map, delta_map, static_cast<T*>(dk),
        static_cast<T*>(dv), scratch, counters, work, heads, kv_heads, t_q,
        t_k, causal, scale, window);
  } else {
    const dim3 grid((t_k + BK - 1) / BK, batch * kv_heads);
    const size_t smem = dkv_f32_smem_floats<D>() * sizeof(float);
    err = allow_smem(flash_bwd_dkv_f32<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_f32<D><<<grid, FMA_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), heads,
        kv_heads, t_q, t_k, causal, scale, window);
  }
  return (int)cudaGetLastError();
}

cudaError_t bad_shape(int batch, int heads, int kv_heads, int t_q, int t_k,
                      int rows) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads ||
      t_q <= 0 || t_k <= 0 || rows > 65535)
    return cudaErrorInvalidValue;
  return check_device();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns 0 or the CUDA
// error of the launch; the caller checks shapes, dtypes, contiguity and
// alignment, and computes delta' = rowsum(dO * O) - g_lse. bf16 also
// takes the work list (on the card) dealt to `blocks` blocks; bf16 dkv
// takes lse and delta' with their rows padded to a multiple of 4 floats
// ([B*H, Tq rounded up to 4]) and, with more than one query head per kv
// head, a float32 scratch of B * Hkv * ceil(Tk / 128) * 128 * D * 2
// values and B * Hkv * ceil(Tk / 128) int32 counters, zeroed. float32
// ignores all of these.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, const void* work,
                            int batch, int heads, int kv_heads, int t_q,
                            int t_k, int head_dim, int is_bf16, int causal,
                            float scale, int window, int blocks,
                            void* stream) {
  const cudaError_t bad =
      bad_shape(batch, heads, kv_heads, t_q, t_k, batch * heads);
  if (bad != cudaSuccess) return (int)bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* w = static_cast<const int*>(work);
  if (head_dim == 128)
    return launch_dq<128>(is_bf16, q, k, v, dout, lse, delta, dq, w, blocks,
                          batch, heads, kv_heads, t_q, t_k, causal, scale,
                          window, s);
  if (head_dim == 64)
    return launch_dq<64>(is_bf16, q, k, v, dout, lse, delta, dq, w, blocks,
                         batch, heads, kv_heads, t_q, t_k, causal, scale,
                         window, s);
  if (head_dim == 32)
    return launch_dq<32>(is_bf16, q, k, v, dout, lse, delta, dq, w, blocks,
                         batch, heads, kv_heads, t_q, t_k, causal, scale,
                         window, s);
  if (head_dim == 16)
    return launch_dq<16>(is_bf16, q, k, v, dout, lse, delta, dq, w, blocks,
                         batch, heads, kv_heads, t_q, t_k, causal, scale,
                         window, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             const void* work, void* scratch, void* counters,
                             int batch, int heads, int kv_heads, int t_q,
                             int t_k, int head_dim, int is_bf16, int causal,
                             float scale, int window, int blocks,
                             void* stream) {
  const cudaError_t bad =
      bad_shape(batch, heads, kv_heads, t_q, t_k, batch * kv_heads);
  if (bad != cudaSuccess) return (int)bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* w = static_cast<const int*>(work);
  float* sc = static_cast<float*>(scratch);
  int* ct = static_cast<int*>(counters);
  if (head_dim == 128)
    return launch_dkv<128>(is_bf16, q, k, v, dout, lse, delta, dk, dv, w, sc,
                           ct, blocks, batch, heads, kv_heads, t_q, t_k,
                           causal, scale, window, s);
  if (head_dim == 64)
    return launch_dkv<64>(is_bf16, q, k, v, dout, lse, delta, dk, dv, w, sc,
                          ct, blocks, batch, heads, kv_heads, t_q, t_k,
                          causal, scale, window, s);
  if (head_dim == 32)
    return launch_dkv<32>(is_bf16, q, k, v, dout, lse, delta, dk, dv, w, sc,
                          ct, blocks, batch, heads, kv_heads, t_q, t_k,
                          causal, scale, window, s);
  if (head_dim == 16)
    return launch_dkv<16>(is_bf16, q, k, v, dout, lse, delta, dk, dv, w, sc,
                          ct, blocks, batch, heads, kv_heads, t_q, t_k,
                          causal, scale, window, s);
  return (int)cudaErrorInvalidValue;
}
