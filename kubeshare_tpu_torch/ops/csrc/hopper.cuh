// Hopper (sm_90a) building blocks of the bf16 flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): mbarriers and the ring of stages they
// guard, TMA tile loads through a tensor map (and the host code that
// encodes the map), wgmma descriptors and the wgmma products the kernels
// start. Raw PTX, so the kernels build in seconds with no header beyond
// the CUDA toolkit's.
//
// Shared-memory tiles are column boxes of [rows][COLS] bf16, each written
// by one TMA box with the swizzle as wide as a box's row (a box's inner
// extent is at most the swizzle's width): COLS = 64 with the 128-byte
// swizzle for head dims 64 and 128, COLS = 32 with the 64-byte swizzle
// for head dim 32, COLS = 16 with the 32-byte swizzle for head dim 16
// (Tile<D>). Row r sits at r * ROW_BYTES and its 16-byte chunk c at chunk
// c ^ (r % 8) (128-byte), c ^ ((r / 2) % 4) (64-byte) or c ^ ((r / 4) % 2)
// (32-byte). Every box starts on a multiple of 8 rows (1024, 512 or 256
// bytes, the swizzle's period), so a wgmma descriptor may point anywhere
// inside it by plain address arithmetic. Nothing addresses a tile by
// hand: TMA writes the boxes and wgmma reads them through descriptors
// that name the same swizzle, so the pattern lives in two places only
// (tensor_map and sw_desc below).

#pragma once

#include <cuda.h>  // CUtensorMap (a type only: no link to libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// bf16 columns of one swizzled TMA box of a head dim d row: 64, or the
// whole row at head dims 32 and 16
constexpr int box_cols(int d) { return d >= 64 ? 64 : d; }

// The tiling of a head dim D: COLS columns a box (box_cols), BOXES boxes
// a row, ROW_BYTES a box row (the swizzle's width), GROUP_BYTES for 8
// rows (the swizzle's period, the stride between 8-row groups), KSTEPS
// k16 steps (32 bytes each) in a box: one at head dim 16, whose products
// over D are then a single k16 step and whose products with N = D
// (P V, dS K, P^T dO, dS^T Q) are m64n16k16.
template <int D>
struct Tile {
  static constexpr int COLS = box_cols(D);
  static constexpr int BOXES = D / COLS;
  static constexpr int ROW_BYTES = COLS * 2;
  static constexpr int GROUP_BYTES = 8 * ROW_BYTES;
  static constexpr int KSTEPS = COLS / 16;
  static_assert(D == 16 || D == 32 || D == 64 || D == 128,
                "the flash kernels are built for head dims 16, 32, 64, 128");
  static_assert(BOXES >= 1 && BOXES * COLS == D, "a row is whole boxes");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also tells the barrier to expect `bytes` from TMA
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// spin until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  if (lane == 0) mbar_arrive(bar);  // one arrival per consumer warp
}

// A position in a ring of STAGES stages: the stage and the parity of its
// current use. Producer and consumers walk it in the same order, across
// all of a block's work items.
template <int STAGES>
struct Ring {
  int stage = 0, phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) stage = 0, phase ^= 1;
  }
};

// ---- TMA ------------------------------------------------------------------

// Copy the box at (c0 = column, c1 = row, c2 = matrix) of a 3-D tensor map
// into shared memory; the barrier's transaction count falls by the box's
// bytes when it lands. Rows outside the matrix arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Copy the box at element c0 of a 1-D tensor map; elements past its end
// arrive as zeros. Keep the box's start 16-byte aligned: a box of
// float32 values starting at element 33 faulted on the card.
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// ---- shared memory -------------------------------------------------------

// Bytes of dynamic shared memory for a kernel's layout Smem, with room to
// align its base to 1024 (the swizzle's period), and the aligned layout.
template <typename Smem>
constexpr size_t smem_bytes() {
  return sizeof(Smem) + 1024;
}

template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024 - smem_u32(raw) % 1024) % 1024;
  return *reinterpret_cast<Smem*>(raw + pad);
}

// ---- warp specialisation -------------------------------------------------

template <int REGS>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---- wgmma ------------------------------------------------------------------

// Descriptor of a swizzled operand in shared memory whose box rows are
// ROW_BYTES wide (128: the 128-byte swizzle, layout type 1; 64: the
// 64-byte swizzle, layout type 2; 32: the 32-byte swizzle, layout type
// 3; bits 62-63). lbo / sbo in bytes. K-major (the depth
// contiguous, as Q and K): sbo is the stride between 8-row groups (8 box
// rows) and lbo is unused. MN-major (the output columns contiguous, as V
// in P V): lbo is the stride between column boxes and sbo between groups
// of 8 depth rows (8 box rows).
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t sw_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64 || ROW_BYTES == 32,
                "128-, 64- or 32-byte rows");
  constexpr uint64_t layout = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= layout << 62;  // the swizzle's layout type
  return d;
}

// A K-major operand of head dim D at p: k step kk of a box is p + (kk %
// KSTEPS) * 16, the next box BOXES boxes on (the caller's indexing).
template <int D>
__device__ __forceinline__ uint64_t k_desc(const void* p) {
  return sw_desc<Tile<D>::ROW_BYTES>(p, 16, Tile<D>::GROUP_BYTES);
}

// An MN-major B operand of head dim D at p (k step kk: 16 box rows on),
// whose column boxes are box_bytes apart.
template <int D>
__device__ __forceinline__ uint64_t mn_desc(const void* p, uint32_t box_bytes) {
  return sw_desc<Tile<D>::ROW_BYTES>(p, box_bytes, Tile<D>::GROUP_BYTES);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout of m64nNk16 (float32), N/2 values a thread: warp w of
// the warpgroup holds rows 16 w .. 16 w + 15; with g = lane / 4 and
// tig = lane % 4, d[4 j], d[4 j + 1] are row g, columns 8 j + 2 tig and
// + 1; d[4 j + 2], d[4 j + 3] the same columns of row g + 8. The A
// fragment of a register-sourced product (k step of 16) has the same
// shape as two such 8-column chunks packed to bf16 pairs.

#define HK_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HK_F16(d, i) \
  HK_F4(d, i), HK_F4(d, i + 4), HK_F4(d, i + 8), HK_F4(d, i + 12)
#define HK_R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define HK_R16                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HK_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HK_R64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A B with A and B in shared memory, both K-major; accumulate when
// `accumulate` is nonzero, else overwrite d.
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HK_R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : HK_F16(d, 0), HK_F16(d, 16)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaSS<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HK_R64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : HK_F16(d, 0), HK_F16(d, 16), HK_F16(d, 32), HK_F16(d, 48)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

// d += A B with A (bf16 pairs, the accumulator layout above) in registers
// and B in shared memory, MN-major (the transpose bit set).
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<16> {
  __device__ __forceinline__ static void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " HK_R8
        ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : HK_F4(d, 0), HK_F4(d, 4)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<32> {
  __device__ __forceinline__ static void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HK_R16
        ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : HK_F16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HK_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HK_F16(d, 0), HK_F16(d, 16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HK_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : HK_F16(d, 0), HK_F16(d, 16), HK_F16(d, 32), HK_F16(d, 48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef HK_F4
#undef HK_F16
#undef HK_R8
#undef HK_R16
#undef HK_R32
#undef HK_R64

// ---- host side: tensor maps and the card -------------------------------

// cuTensorMapEncodeTiled is a driver-API call; it is reached through the
// runtime's cudaGetDriverEntryPoint, so the libraries need no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The 3-D map (D, rows, matrices) of a contiguous [matrices, rows, D] bf16
// tensor, read in boxes of box_cols(D) columns x box_rows rows of one
// matrix with the swizzle as wide as a box row (128 bytes at D >= 64, 64
// at D = 32, 32 at D = 16); rows past `rows` read as zeros.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int d, int rows,
                       int matrices, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int cols = box_cols(d);
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)matrices};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                   : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The 1-D map of n contiguous float32 values, read in boxes of `box`
// (no swizzle); values past n read as zeros.
cudaError_t tensor_map_f32(CUtensorMap* map, const float* base, size_t n,
                           int box) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};  // rank 1: not read
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t unit[1] = {1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base), dims,
      strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The kernels are built for sm_90a alone: on any other card, fail loudly.
cudaError_t check_device() {
  int dev = 0, major = 0, minor = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&major, cudaDevAttrComputeCapabilityMajor,
                                 dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&minor, cudaDevAttrComputeCapabilityMinor,
                                 dev);
  if (err != cudaSuccess) return err;
  return major == 9 && minor == 0 ? cudaSuccess
                                  : cudaErrorNoKernelImageForDevice;
}

}  // namespace
