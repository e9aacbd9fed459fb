// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// tile sizes, the key range and mask of a tile, and the bf16 tensor-core
// helpers (ldmatrix, mma.sync m16n8k16, cp.async).
//
// Who uses what. The bf16 forward (flash_fwd_bf16) has its own tiles
// (FWD_BM, FWD_BN in flash_fwd.cu), Hopper helpers (hopper.cuh) and key
// ranges (its work list, built on the host); of this file it takes
// visible, NEG_INF, pack_bf16 and allow_smem. BQ, BK, LDQ, LDK,
// FMA_THREADS and key_range are the float32 kernels' (forward and
// backward) and the bf16 backward's. MMA_THREADS, the ldmatrix / mma.sync
// / cp.async helpers, load_tile_async, load_rows_f32_async and fast_exp
// are the backward's alone.
//
// Positions: causal rows align to the end of the keys (query i sits at
// position i + Tk - Tq; the wrappers require Tq <= Tk). A pair (query at
// qpos, key at kpos) is visible when kpos < Tk and, under a causal mask,
// kpos <= qpos and, with a window, kpos > qpos - window. Masked scores are
// -1e30, as in the reference kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per q tile
constexpr int BK = 64;  // keys per tile (FLASH_BLOCK_K in attention.py)
constexpr float NEG_INF = -1e30f;

constexpr int MMA_THREADS = 128;  // bf16 kernels: 4 warps x 16 rows
constexpr int FMA_THREADS = 256;  // float32 kernels: a 16 x 16 grid
constexpr int LDQ = BQ + 1;       // padded leading dims of the float32
constexpr int LDK = BK + 1;       // kernels' tiles: conflict-free stores

// Keys [lo, hi) that any real query of the q tile at q0 can see, and the
// absolute position of the tile's first query.
struct KeyRange {
  int lo, hi, q_first;
};

__device__ __forceinline__ KeyRange key_range(int q0, int t_q, int t_k,
                                              int causal, int window) {
  const int offset = causal ? t_k - t_q : 0;
  KeyRange r{0, t_k, q0 + offset};
  if (causal) {
    r.hi = min(t_k, min(q0 + BQ, t_q) - 1 + offset + 1);
    if (window > 0) r.lo = max(0, r.q_first - window + 1);
  }
  r.lo -= r.lo % BK;  // tiles are aligned to BK
  return r;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int t_k,
                                        int causal, int window) {
  bool vis = kpos < t_k;
  if (causal) {
    vis = vis && kpos <= qpos;
    if (window > 0) vis = vis && kpos > qpos - window;
  }
  return vis;
}

// ---- bf16 tensor-core helpers ----------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16x16, row) * b (16x8, col); bf16 operands, float32 sums.
// Fragment coordinates, with g = lane / 4 and tig = lane % 4: c[0], c[1]
// are row g, columns 2 tig and 2 tig + 1; c[2], c[3] the same columns of
// row g + 8. a[0] holds row g, columns 2 tig..+1; a[1] row g + 8; a[2] and
// a[3] the same rows at columns 8 + 2 tig..+1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments (16 rows x 16 columns at column 16 j) of the product's left
// side, read from a row-major bf16 tile in shared memory with leading dim
// ld, for the warp whose rows start at row0.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int row0, int j) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, tile + (row0 + lane % 16) * ld + j * 16 + (lane / 16) * 8);
}

// B fragments of two 8-column tiles (columns n0..n0+15 of the product)
// when B's columns are ROWS of a row-major tile (B = tile^T, as K in
// Q K^T): rows n0..n0+15, depth 16 st..16 st+15. b[0], b[1] feed column
// tile n0, b[2], b[3] column tile n0 + 8.
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4],
                                            const __nv_bfloat16* tile, int ld,
                                            int n0, int st) {
  const int lane = threadIdx.x % 32, mi = lane / 8, mr = lane % 8;
  ldmatrix_x4(b, tile + (n0 + mr + 8 * (mi >> 1)) * ld + st * 16 +
                     8 * (mi & 1));
}

// B fragments of two 8-column tiles when B is the row-major tile itself
// (depth = its rows, as V in P V): rows 16 j..16 j+15, columns n0..n0+15.
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4],
                                            const __nv_bfloat16* tile, int ld,
                                            int j, int n0) {
  const int lane = threadIdx.x % 32, mi = lane / 8, mr = lane % 8;
  ldmatrix_x4_trans(b, tile + (j * 16 + mr + 8 * (mi & 1)) * ld + n0 +
                           8 * (mi >> 1));
}

// e^x as 2^(x log2 e) on the special-function unit (relative error at
// most 2^-22). x is a difference of two scores: exactly 0 when both are
// the -1e30 mask, which gives 1 as expf does, and about -1.4e30 for a
// masked score against a real maximum, which gives 0.
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in low bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// Start copying rows [row0, row0 + ROWS) of a [rows, D] bf16 matrix into
// shared memory with leading dim D + 8 (16 extra bytes per row: the
// eight row reads of an ldmatrix then fall in distinct banks), 16 bytes
// per cp.async; rows past n_rows are zero-filled. The block has
// MMA_THREADS threads (a compile-time stride: the loop unrolls).
template <int D, int ROWS = 64>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int row0, int n_rows) {
  constexpr int VEC = D / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < ROWS * VEC; idx += MMA_THREADS) {
    const int r = idx / VEC, c = idx % VEC;
    const bool in = row0 + r < n_rows;
    // a zero-filled copy reads nothing, but its address stays in bounds
    const __nv_bfloat16* from = src + (size_t)(in ? row0 + r : 0) * D + c * 8;
    const uint32_t to = static_cast<uint32_t>(
        __cvta_generic_to_shared(dst + r * (D + 8) + c * 8));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(to), "l"(from), "r"(in ? 16 : 0));
  }
}

// Start copying n floats src[row0 .. row0 + n) into shared memory, 4 bytes
// per cp.async; entries past n_rows are zero-filled.
__device__ __forceinline__ void load_rows_f32_async(float* dst,
                                                    const float* src, int row0,
                                                    int n, int n_rows) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const bool in = row0 + r < n_rows;
    const float* from = src + (in ? row0 + r : 0);
    const uint32_t to =
        static_cast<uint32_t>(__cvta_generic_to_shared(dst + r));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(to), "l"(from), "r"(in ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Opt a kernel into more than 48 KB of dynamic shared memory (per device,
// so on every launch: the call is cheap).
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
