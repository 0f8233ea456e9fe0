// Flash-attention backward for Hopper (sm_90a), behind a plain C interface:
// the FlashAttention-2 split into a dK/dV kernel and a dQ kernel.
//
// Replaces the TPU kernels of ray_tpu/ops/attention.py `_flash_backward`:
//   * dK/dV: pl.pallas_call at attention.py:280, kernel body
//     `_flash_bwd_dkv_kernel` at :158 (the column pass);
//   * dQ:    pl.pallas_call at attention.py:303, kernel body
//     `_flash_bwd_dq_kernel` at :210 (the row pass).
// Both recompute p = exp(s * sm_scale - lse) from the forward's per-row lse,
// with top-left causality (row >= col), so no score matrix ever reaches
// device memory.  A masked pair gets p = 0, which is what the TPU kernels'
// exp(-1e30 - lse) gives.  With delta = rowsum(dO * O)
// (computed in torch by the caller, as XLA does in the JAX package):
//   dV = p^T dO,  dS = p * (dO V^T - delta) * sm_scale,  dK = dS^T Q,
//   dQ = dS K.
// A query row with lse = +1e30 (it saw no column in the forward) gets p = 0.
//
// Layout: q, dO (bh, seq_q, d); k, v (bh_kv, seq_k, d); all contiguous, in
// float32 or bfloat16; lse, delta (bh, seq_q) f32; dq in q's type, dk and dv
// in k's type.  Grouped-query attention: query head bh reads KV head
// bh / (bh / bh_kv), as in flash_fwd.cu.  dK and dV of a KV head are the sums
// over the query heads of its group: the dK/dV block loops over those heads
// itself, so no atomics are needed and the result is the same from run to
// run.
//
// What bounds them on this card: per unmasked (query, key) pair the dK/dV
// pass does 8 * d operations (two dot products, two rank-1 updates) and the
// dQ pass 6 * d; each moves about 8 * d bytes per row in bf16.  For the
// trainer's causal seq 1024 that is well above the H100's ~295 op/byte
// ridge, so the least time is set by the bf16 tensor cores.  This first
// version reaches neither limit: it is scalar f32 FMA, like flash_fwd.cu,
// which keeps the float32 path within summation-order error of the plain
// version.  What the design does:
//   * dK/dV: one block per (bh_kv, 64-row KV tile), 4 threads per KV row;
//     each thread keeps its quarter of the K and V rows and of the dK and dV
//     accumulators in registers for the whole sweep over the group's query
//     heads and the Q tiles from the first one the causal mask lets see
//     this KV tile.  Q and dO are staged in shared memory 32 rows at a time
//     as f32, with their lse and delta, and read back as float4 broadcasts.
//     dK and dV are accumulated in f32 and rounded once on store.
//   * dQ: one block per (bh, 64-row Q tile), 4 threads per query row, Q, dO
//     and the dQ accumulator in registers; K and V are staged 32 rows at a
//     time, up to the diagonal tile, as the forward does.
//   * both dot products of a pair (q.k and dO.v) are summed with two xor
//     shuffles among the 4 adjacent lanes of one row only;
//   * staged rows past seq are zero-filled and masked or out-of-range pairs
//     get p = 0 exactly, so they contribute exactly 0 (no garbage * 0 = NaN).
// Static shared memory stays under 33 KB for d <= 128.  Tensor-core
// products (mma.sync / wgmma), TMA staging and warp specialisation are the
// next steps for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kThreadsPerRow = 4;  // lanes that share one row
constexpr int kRowsPerBlock = 64;  // KV rows (dK/dV) or Q rows (dQ) per block
constexpr int kThreads = kRowsPerBlock * kThreadsPerRow;
constexpr int kStageRows = 32;     // rows staged in shared memory per tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum over the 4 adjacent lanes of one row (xor 1, 2 stay inside the group).
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Thread `part` of a row owns dims c * 16 + part * 4 + e (c < D / 16, e < 4),
// as in flash_fwd.cu: the 4 lanes of a row read 64 contiguous bytes.
template <int D>
__device__ __forceinline__ float dot_row(const float (&reg)[D / 4],
                                         const float* row, int part) {
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(&row[c * 16 + part * 4]);
    dot = fmaf(reg[c * 4 + 0], x.x, dot);
    dot = fmaf(reg[c * 4 + 1], x.y, dot);
    dot = fmaf(reg[c * 4 + 2], x.z, dot);
    dot = fmaf(reg[c * 4 + 3], x.w, dot);
  }
  return dot;
}

// acc += a * row (this thread's dims of a staged row)
template <int D>
__device__ __forceinline__ void axpy_row(float (&acc)[D / 4], float a,
                                         const float* row, int part) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(&row[c * 16 + part * 4]);
    acc[c * 4 + 0] = fmaf(a, x.x, acc[c * 4 + 0]);
    acc[c * 4 + 1] = fmaf(a, x.y, acc[c * 4 + 1]);
    acc[c * 4 + 2] = fmaf(a, x.z, acc[c * 4 + 2]);
    acc[c * 4 + 3] = fmaf(a, x.w, acc[c * 4 + 3]);
  }
}

// This thread's dims of global row `row` of `base` (zeros when !ok).
template <typename T, int D>
__device__ __forceinline__ void load_row(float (&reg)[D / 4], const T* base,
                                         bool ok, int part) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      reg[c * 4 + e] = ok ? to_float(base[c * 16 + part * 4 + e]) : 0.f;
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* base, const float (&reg)[D / 4],
                                          int part) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      base[c * 16 + part * 4 + e] = from_float<T>(reg[c * 4 + e]);
    }
  }
}

// Stage rows [r0, r0 + kStageRows) of two (rows, D) arrays into shared
// memory as f32, zero-filling rows at or past n_rows.
template <typename T, int D>
__device__ __forceinline__ void stage_tiles(float (*a_tile)[D],
                                            float (*b_tile)[D], const T* a,
                                            const T* b, int r0, int n_rows,
                                            int tid) {
  for (int idx = tid; idx < kStageRows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    float ax = 0.f, bx = 0.f;
    if (r0 + r < n_rows) {
      ax = to_float(a[(size_t)(r0 + r) * D + c]);
      bx = to_float(b[(size_t)(r0 + r) * D + c]);
    }
    a_tile[r][c] = ax;
    b_tile[r][c] = bx;
  }
}

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ d_out,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int group, int seq_q, int seq_k,
                     float sm_scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  static_assert(2 * kStageRows * D * sizeof(float) <= 48 * 1024,
                "static shared memory is capped at 48 KB");
  __shared__ __align__(16) float q_tile[kStageRows][D];
  __shared__ __align__(16) float do_tile[kStageRows][D];
  __shared__ float lse_tile[kStageRows];
  __shared__ float delta_tile[kStageRows];

  const int kv_bh = blockIdx.y;
  const int kv0 = blockIdx.x * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int part = tid % kThreadsPerRow;
  const int col = kv0 + tid / kThreadsPerRow;  // this thread's KV row
  const bool col_ok = col < seq_k;

  float kr[D / 4], vr[D / 4], dk_acc[D / 4], dv_acc[D / 4];
  const size_t kv_off = ((size_t)kv_bh * seq_k + (col_ok ? col : 0)) * D;
  load_row<T, D>(kr, k + kv_off, col_ok, part);
  load_row<T, D>(vr, v + kv_off, col_ok, part);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  const int n_tiles = (seq_q + kStageRows - 1) / kStageRows;
  // causal: query rows before this KV tile's first row never see it
  const int first_tile = kCausal ? kv0 / kStageRows : 0;

  for (int g = 0; g < group; ++g) {
    const int bh = kv_bh * group + g;
    const T* q_base = q + (size_t)bh * seq_q * D;
    const T* do_base = d_out + (size_t)bh * seq_q * D;
    for (int t = first_tile; t < n_tiles; ++t) {
      const int q0 = t * kStageRows;
      __syncthreads();  // every thread is done with the previous tile
      stage_tiles<T, D>(q_tile, do_tile, q_base, do_base, q0, seq_q, tid);
      if (tid < kStageRows) {
        const bool ok = q0 + tid < seq_q;
        const size_t r = (size_t)bh * seq_q + q0 + tid;
        lse_tile[tid] = ok ? lse[r] : 0.f;
        delta_tile[tid] = ok ? delta[r] : 0.f;
      }
      __syncthreads();

      for (int i = 0; i < kStageRows; ++i) {
        const int row = q0 + i;
        const float s = row_sum(dot_row<D>(kr, q_tile[i], part)) * sm_scale;
        const bool masked =
            row >= seq_q || !col_ok || (kCausal && row < col);
        const float p = masked ? 0.f : expf(s - lse_tile[i]);
        axpy_row<D>(dv_acc, p, do_tile[i], part);
        const float dp = row_sum(dot_row<D>(vr, do_tile[i], part));
        const float ds = p * (dp - delta_tile[i]) * sm_scale;
        axpy_row<D>(dk_acc, ds, q_tile[i], part);
      }
    }
  }

  if (!col_ok) return;
  store_row<T, D>(dk + kv_off, dk_acc, part);
  store_row<T, D>(dv + kv_off, dv_acc, part);
}

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ d_out,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int group, int seq_q, int seq_k, float sm_scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  static_assert(2 * kStageRows * D * sizeof(float) <= 48 * 1024,
                "static shared memory is capped at 48 KB");
  __shared__ __align__(16) float k_tile[kStageRows][D];
  __shared__ __align__(16) float v_tile[kStageRows][D];

  const int bh = blockIdx.y;
  const int kv_bh = bh / group;
  const int q0 = blockIdx.x * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int part = tid % kThreadsPerRow;
  const int row = q0 + tid / kThreadsPerRow;  // this thread's query row
  const bool row_ok = row < seq_q;

  float qr[D / 4], dor[D / 4], dq_acc[D / 4];
  const size_t q_off = ((size_t)bh * seq_q + (row_ok ? row : 0)) * D;
  load_row<T, D>(qr, q + q_off, row_ok, part);
  load_row<T, D>(dor, d_out + q_off, row_ok, part);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dq_acc[i] = 0.f;
  const float row_lse = row_ok ? lse[(size_t)bh * seq_q + row] : 0.f;
  const float row_delta = row_ok ? delta[(size_t)bh * seq_q + row] : 0.f;

  const T* k_base = k + (size_t)kv_bh * seq_k * D;
  const T* v_base = v + (size_t)kv_bh * seq_k * D;
  int n_tiles = (seq_k + kStageRows - 1) / kStageRows;
  if (kCausal) {
    // only tiles at or before this block's last query row take part
    n_tiles = min(n_tiles, (q0 + kRowsPerBlock + kStageRows - 1) / kStageRows);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kStageRows;
    __syncthreads();  // every thread is done with the previous tile
    stage_tiles<T, D>(k_tile, v_tile, k_base, v_base, kv0, seq_k, tid);
    __syncthreads();

    for (int j = 0; j < kStageRows; ++j) {
      const int col = kv0 + j;
      const float s = row_sum(dot_row<D>(qr, k_tile[j], part)) * sm_scale;
      const bool masked = !row_ok || col >= seq_k || (kCausal && col > row);
      const float p = masked ? 0.f : expf(s - row_lse);
      const float dp = row_sum(dot_row<D>(dor, v_tile[j], part));
      const float ds = p * (dp - row_delta) * sm_scale;
      axpy_row<D>(dq_acc, ds, k_tile[j], part);
    }
  }

  if (!row_ok) return;
  store_row<T, D>(dq + q_off, dq_acc, part);
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* d_out, const float* lse,
                       const float* delta, void* dk, void* dv, int bh_kv,
                       int group, int seq_q, int seq_k, bool causal,
                       float sm_scale, cudaStream_t stream) {
  const dim3 grid((seq_k + kRowsPerBlock - 1) / kRowsPerBlock, bh_kv);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(d_out);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
  if (causal) {
    flash_bwd_dkv_kernel<T, D, true><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, dop, lse, delta, dkp, dvp, group, seq_q, seq_k, sm_scale);
  } else {
    flash_bwd_dkv_kernel<T, D, false><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, dop, lse, delta, dkp, dvp, group, seq_q, seq_k, sm_scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* d_out, const float* lse, const float* delta,
                      void* dq, int bh, int group, int seq_q, int seq_k,
                      bool causal, float sm_scale, cudaStream_t stream) {
  const dim3 grid((seq_q + kRowsPerBlock - 1) / kRowsPerBlock, bh);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(d_out);
  T* dqp = static_cast<T*>(dq);
  if (causal) {
    flash_bwd_dq_kernel<T, D, true><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, dop, lse, delta, dqp, group, seq_q, seq_k, sm_scale);
  } else {
    flash_bwd_dq_kernel<T, D, false><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, dop, lse, delta, dqp, group, seq_q, seq_k, sm_scale);
  }
  return cudaGetLastError();
}

// Shape checks shared by both entry points: 0 when the launch may go ahead.
// `grid_rows` is the length the kernel's grid walks; an empty grid is not a
// launch.
int check_shape(int bh, int bh_kv, int seq_q, int seq_k, int grid_rows) {
  if (bh <= 0 || bh_kv <= 0 || bh % bh_kv != 0 || bh > 65535 || seq_q < 0 ||
      seq_k < 0 || grid_rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaSuccess;
}

// Returns LAUNCH<T, D>(...) for the runtime dtype and head_dim, or
// cudaErrorInvalidValue for one the kernels do not take.
#define RTT_DISPATCH(LAUNCH, dtype, head_dim, ...)                        \
  do {                                                                    \
    if ((dtype) == 0) {                                                   \
      switch (head_dim) {                                                 \
        case 32: return (int)LAUNCH<float, 32>(__VA_ARGS__);              \
        case 64: return (int)LAUNCH<float, 64>(__VA_ARGS__);              \
        case 128: return (int)LAUNCH<float, 128>(__VA_ARGS__);            \
      }                                                                   \
    } else if ((dtype) == 1) {                                            \
      switch (head_dim) {                                                 \
        case 32: return (int)LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);      \
        case 64: return (int)LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);      \
        case 128: return (int)LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);    \
      }                                                                   \
    }                                                                     \
    return (int)cudaErrorInvalidValue;                                    \
  } while (0)

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns the cudaError_t of its
// launch (0 on success); the caller raises on anything else.  The dK/dV
// kernel needs seq_k > 0 and the dQ kernel seq_q > 0; each writes every
// element of its outputs.

extern "C" int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* d_out, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int bh, int bh_kv, int seq_q, int seq_k,
                                 int head_dim, int causal, float sm_scale,
                                 int dtype, void* stream) {
  const int rc = check_shape(bh, bh_kv, seq_q, seq_k, seq_k);
  if (rc != 0) return rc;
  RTT_DISPATCH(launch_dkv, dtype, head_dim, q, k, v, d_out,
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, bh_kv, bh / bh_kv,
               seq_q, seq_k, causal != 0, sm_scale,
               static_cast<cudaStream_t>(stream));
}

extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* d_out, const void* lse,
                                const void* delta, void* dq, int bh,
                                int bh_kv, int seq_q, int seq_k, int head_dim,
                                int causal, float sm_scale, int dtype,
                                void* stream) {
  const int rc = check_shape(bh, bh_kv, seq_q, seq_k, seq_q);
  if (rc != 0) return rc;
  RTT_DISPATCH(launch_dq, dtype, head_dim, q, k, v, d_out,
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, bh, bh / bh_kv, seq_q,
               seq_k, causal != 0, sm_scale,
               static_cast<cudaStream_t>(stream));
}
