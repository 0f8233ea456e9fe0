// Tile mechanics shared by the tensor-core flash-attention kernels
// (flash_fwd.cu `flash_fwd_mma_kernel`, flash_bwd.cu
// `flash_bwd_dq_mma_kernel` and `flash_bwd_dkv_mma_kernel`): bf16 tiles of
// 64 rows staged in shared memory by 16-byte cp.async copies, read into
// mma.sync m16n8k16 fragments with ldmatrix, and the products on Hopper's
// tensor cores with f32 sums.
//
// One block of 4 warps owns a 64-row tile, each warp 16 of its rows, and
// tiles of 64 rows stream past it in a 2-stage ring.  The forward and dQ
// are query-stationary (a tile of one head's queries; K/V tiles stream);
// dK/dV is KV-stationary (a tile of one KV head's keys; Q/dO tiles of the
// query heads of its group stream, and its scores come out transposed:
// keys are rows, queries columns).
//
// Fragment layouts of mma.sync.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), with lane = 4 * g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 registers of 2 bf16:
//     a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16 x 8, k x n), 2 registers:  b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   C (16 x 8, f32):  c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// So the C fragments of two adjacent n8 tiles are, element for element,
// the A fragment of one k16 slab: a score tile becomes the A operand of the
// next product in registers (pack_a), with no shared-memory round trip.
//
// tests/test_torch_attention_tc_numerics.py emulates these kernels' tile
// sizes and rounding points in torch to check chip_smoke.py's tolerances on
// the CPU; a change to either here must change the emulation with it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace rtt_mma {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;  // rows per block = rows per streamed tile
constexpr int kWarps = 4;  // each warp owns 16 of the block's rows
constexpr int kThreads = 32 * kWarps;
constexpr int kKeyTiles = kRows / 8;  // n8 score tiles per streamed tile
constexpr float kNegInf = -1e30f;     // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A shared-memory tile of 64 rows of D bf16, each row padded by 16 bytes:
// the 8 rows one ldmatrix phase reads then start 16 bytes apart modulo the
// 128-byte bank window (stride 2D + 16 = 16 mod 128 for D = 64, 128; D = 32
// steps by 80, also 8 distinct 16-byte slots), so the reads are free of bank
// conflicts, and every row stays 16-byte aligned for cp.async.
template <int D>
struct Tile {
  static constexpr int kStride = D + 8;  // bf16 elements per smem row
  static constexpr int kElems = kRows * kStride;
  static constexpr int kBytes = kElems * (int)sizeof(bf16);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1; with `valid` false the
// source size is 0 and the 16 bytes are zero-filled (nothing is read).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

// 4-byte global -> shared copy (cp.async.ca), for rows that are only
// 4-byte aligned: lse and delta when seq_q % 4 != 0.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of rows [r0, r0 + 64) of a contiguous (n_rows, D) array
// into `tile`; rows at or past n_rows are zero-filled by the copy itself.
// Every thread of the block takes part; the caller commits the group.
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, int r0,
                                          int n_rows, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert((kRows * kChunks) % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int idx = i * kThreads + tid;
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool ok = r0 + r < n_rows;
    // a zero-filled row still names a valid address (row 0 of the head)
    const bf16* g = src + (size_t)(ok ? r0 + r : 0) * D + c;
    cp_async_16(smem_u32(tile + r * Tile<D>::kStride + c), g, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b on the tensor cores: 16 x 8 f32 += (16 x 16 bf16)(16 x 8 bf16).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [row0, row0 + 16) x cols [k0, k0 + 16) of a
// row-major tile: lanes 0-15 name rows row0.. at col k0 (a0, a1), lanes
// 16-31 the same rows at col k0 + 8 (a2, a3).
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t tile,
                                       int row0, int k0, int lane) {
  const int r = row0 + (lane & 15);
  const int c = k0 + (lane >> 4) * 8;
  ldsm_x4(a, tile + (uint32_t)(r * Tile<D>::kStride + c) * 2u);
}

// B fragments of X * T^T, T a row-major tile of the streamed rows (K for
// the scores, V for dO * V^T; Q for K * Q^T, dO for V * dO^T in dK/dV): k
// is the head dim, n the tile's row.  Two n8 tiles, rows [n0, n0 + 8) in
// b[0], b[1] and [n0 + 8, n0 + 16) in b[2], b[3], for the head-dim slab
// [k0, k0 + 16).  B column n is T row n, so plain ldmatrix.
template <int D>
__device__ __forceinline__ void load_b_keys(uint32_t (&b)[4], uint32_t tile,
                                            int n0, int k0, int lane) {
  const int r = n0 + (lane & 7) + ((lane >> 4) << 3);
  const int c = k0 + ((lane >> 3) & 1) * 8;
  ldsm_x4(b, tile + (uint32_t)(r * Tile<D>::kStride + c) * 2u);
}

// B fragments of P * T, T a row-major tile of the streamed rows (V for
// P * V, K for dS * K; dO for P^T * dO, Q for dS^T * Q in dK/dV): k is the
// tile's row, n the head dim.  For the row slab [k0, k0 + 16), head dims
// [n0, n0 + 8) in b[0], b[1] and [n0 + 8, n0 + 16) in b[2], b[3].  B row k
// is T row k, so ldmatrix.trans turns each stored 8 x 8 quadrant (8 rows x
// 8 dims) into the (k 2t..2t+1, n g) pairs of the fragment.
template <int D>
__device__ __forceinline__ void load_b_dims(uint32_t (&b)[4], uint32_t tile,
                                            int k0, int n0, int lane) {
  const int r = k0 + (lane & 15);
  const int c = n0 + (lane >> 4) * 8;
  ldsm_x4_trans(b, tile + (uint32_t)(r * Tile<D>::kStride + c) * 2u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of key slab j (keys 16j..16j+15) from the f32 C fragments
// of score tiles 2j and 2j + 1, rounded to bf16 (see the layouts above).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Sum or max over the 4 lanes that share a row of a C fragment.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

// Whether score element e of n8 tile nt (this lane's C fragment) is
// masked: past seq_k, or above the diagonal when causal (top-left, a row
// sees col <= row).  row_a is this lane's first row (g), row_a + 8 its
// second.
template <bool kCausal>
__device__ __forceinline__ bool masked(int kv0, int nt, int e, int t,
                                       int row_a, int seq_k) {
  const int col = kv0 + nt * 8 + 2 * t + (e & 1);
  const int row = row_a + ((e >> 1) << 3);
  return col >= seq_k || (kCausal && col > row);
}

// The same for a transposed score tile (dK/dV: rows are keys, columns
// queries): element e of n8 tile nt is masked when its key is at or past
// seq_k, or when causal and its query comes before its key (col < key).
// q0 is the tile's first query, key_a this lane's first key (g), key_a + 8
// its second.  Queries past seq_q need no mask: their lse is +1e30.
template <bool kCausal>
__device__ __forceinline__ bool masked_t(int q0, int nt, int e, int t,
                                         int key_a, int seq_k) {
  const int col = q0 + nt * 8 + 2 * t + (e & 1);
  const int key = key_a + ((e >> 1) << 3);
  return key >= seq_k || (kCausal && col < key);
}

// Store a 16 x D f32 fragment row pair to rows row_a, row_a + 8 of a
// (rows, D) bf16 array, scaled per row; rows at or past n_rows are skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&acc)[D / 8][4],
                                           int row_a, int n_rows, int t,
                                           float mul_a, float mul_b) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + half * 8;
    if (row >= n_rows) continue;
    const float mul = half ? mul_b : mul_a;
    bf16* p = dst + (size_t)row * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(p + nt * 8) = __floats2bfloat162_rn(
          acc[nt][2 * half] * mul, acc[nt][2 * half + 1] * mul);
    }
  }
}

// Dynamic shared memory above 48 KB must be allowed per kernel first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace rtt_mma
