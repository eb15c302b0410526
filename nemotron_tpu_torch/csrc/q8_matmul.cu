// Blockwise-int8 (GGUF Q8_0) weight matmul for Hopper (sm_90a).
//
//   out[M, N] = x[M, K] @ (q[K, N] * expand32(scale[K/32, N]))
//
// Replaces the Pallas TPU kernel `q8_matmul`
// (nemotron_tpu/ops/quant_kernel.py:58, body `_q8_matmul_kernel` :31-54).
// Numerics follow it: each weight is dequantized as (float)q * scale in f32,
// rounded to the ACTIVATION dtype (f32 or bf16), then multiplied into an f32
// accumulator (FFMA on the CUDA cores, no TF32). Q4_0 weights arrive here as
// int8 in [-8, 7] with a scale.
//
// What bounds it on the card: the streaming step calls it with a skinny M
// (S * Q = 1..14 rows at one stream), so it is one pass over the weight:
// about 27 MB a layer (24.1 MB of int8, 3.0 MB of f32 scales), 8.1 us at
// 3.35 TB/s. At M = 14 in f32 the FMAs (14 per weight byte, 10.08 us a
// layer at 67 TFLOP/s) bound it first. To stream at HBM rate the card needs
// about 25 KB in flight per SM (Little's law at ~1 us of DRAM latency),
// and a grid of at least one wave; a split-K design needs the partial sums
// added without a second launch or a workspace.
//
// Design: one launch per call. The grid is ceil(N / TN) column tiles of
// TN = 32 or 64 columns, each a thread-block cluster of CK <= 8 blocks that
// split K by whole 32-row scale blocks (at least 132 blocks for every
// (K, N) of the encoder, at any M). Each block issues its whole K slice of
// the weight tile, its scales and its x rows ([m][k], in x's dtype) at
// once as 16-byte cp.async copies into shared memory, so the whole slice
// is in flight at once: 4-16 KB of weight a block, 2-4 blocks an SM, up to
// 32 KB an SM. (Splitting the copies into several commit groups and
// computing on each as it lands was slower on the card: the groups land
// together and each wait costs a block barrier.) A block is 4 warps: at
// TM = 16 a thread holds 64 accumulators (about 110 registers), and 8-warp
// blocks halved the blocks an SM holds, so the clusters of a call no
// longer fitted in one wave. A thread owns 4 columns (one 32-bit word of
// weights a row) and every RS-th row of the slice, for up to TM = 16 rows
// of x: it dequantizes each weight once in registers and does TM FMAs with
// it. The threads' partials are added with warp shuffles and then across
// the 4 warps in a fixed order; each block pushes its [TM, TN] partial
// tile into the shared memory of the cluster block that owns those columns
// (distributed shared memory), one cluster barrier, and each block adds its
// columns' partials in rank order and stores them. No workspace, no
// atomics: the result is deterministic. M above 16 loops over 16-row tiles
// inside the block, the weight slice staying in shared memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int QK = 32;            // rows per scale block
constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int MAXCK = 8;          // the portable cluster size

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and XLA
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The split cluster barrier of the start: arrive once the loads are
// issued, wait before the first store into another block's shared memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Byte offsets of one block's shared memory.
struct Layout {
  int wq, ss, xs, red, recv, bytes;
  __host__ __device__ Layout(int TM, int TN, int nsb_max, int ck) {
    const int cw = (TN + ck - 1) / ck;
    wq = 0;                                         // int8 [nsb_max*32][TN]
    ss = wq + nsb_max * QK * TN;                    // f32 [nsb_max][TN]
    xs = ss + nsb_max * TN * 4;                     // x [TM][nsb_max*32]
    red = xs + nsb_max * QK * TM * 4;               // f32 [NW][TM][TN]
    recv = red + NW * TM * TN * 4;                  // f32 [ck][TM][cw]
    bytes = recv + ((ck * TM * cw + 3) / 4) * 16;
  }
};

// Grid: ceil(N / TN) * ck blocks in clusters of ck along K. VEC: N a
// multiple of 16 and x, q, scale 16-byte aligned (cp.async and vector
// loads); else plain loads.
template <typename T, int TM, int TN, bool VEC>
__global__ void __launch_bounds__(THREADS)
q8_matmul_cluster_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                         const float* __restrict__ scale, T* __restrict__ out,
                         int M, int K, int N, int ck) {
  constexpr int CG = TN / 4;            // column groups of 4 (one per lane)
  constexpr int RS = THREADS / CG;      // row slots: a thread's row stride
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / ck) * TN;
  const int nsb = K / QK, nsb_max = (nsb + ck - 1) / ck;
  const int sb0 = rank * nsb / ck, nsbl = (rank + 1) * nsb / ck - sb0;
  const int k0 = sb0 * QK, ks = nsbl * QK;
  const int cw = (TN + ck - 1) / ck;
  const Layout L(TM, TN, nsb_max, ck);
  int8_t* wq = reinterpret_cast<int8_t*>(smem + L.wq);
  float* ss = reinterpret_cast<float*>(smem + L.ss);
  T* xt = reinterpret_cast<T*>(smem + L.xs);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* recv = reinterpret_cast<float*>(smem + L.recv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the block's whole K slice of weights and scales, issued at once
  if constexpr (VEC) {
    for (int c = tid; c < nsbl * CG; c += THREADS) {
      const int r = c / CG, col = (c % CG) * 4;
      float* dst = ss + r * TN + col;
      if (n0 + col < N) cp_async16(dst, scale + (size_t)(sb0 + r) * N + n0 + col);
      else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int c = tid; c < ks * (TN / 16); c += THREADS) {
      const int r = c / (TN / 16), col = (c % (TN / 16)) * 16;
      int8_t* dst = wq + r * TN + col;
      if (n0 + col < N) cp_async16(dst, q + (size_t)(k0 + r) * N + n0 + col);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < nsbl * TN; i += THREADS) {
      const int r = i / TN, col = i % TN;
      ss[i] = n0 + col < N ? scale[(size_t)(sb0 + r) * N + n0 + col] : 0.f;
    }
    for (int i = tid; i < ks * TN; i += THREADS) {
      const int r = i / TN, col = i % TN;
      wq[i] = n0 + col < N ? q[(size_t)(k0 + r) * N + n0 + col] : (int8_t)0;
    }
  }
  cluster_arrive_relaxed();

  const int ksx = nsb_max * QK;
  const int cgi = lane % CG;                      // this thread's 4 columns
  const int rr = warp * (32 / CG) + lane / CG;    // and its first row
  for (int m0 = 0; m0 < M; m0 += TM) {
    // x[m0:m0+TM, k0:k0+ks] -> xt[m][k] in T, zero past M
    if constexpr (VEC) {
      constexpr int EPC = 16 / sizeof(T);
      for (int c = tid; c < TM * (ks / EPC); c += THREADS) {
        const int m = c / (ks / EPC), k = (c % (ks / EPC)) * EPC;
        T* dst = xt + m * ksx + k;
        if (m0 + m < M) cp_async16(dst, x + (size_t)(m0 + m) * K + k0 + k);
        else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
      cp_async_commit();
    } else {
      for (int i = tid; i < TM * ks; i += THREADS) {
        const int m = i / ks, k = i % ks;
        xt[m * ksx + k] = m0 + m < M ? x[(size_t)(m0 + m) * K + k0 + k] : from_f<T>(0.f);
      }
    }
    float acc[TM][4];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
    cp_async_wait_all();
    __syncthreads();
    for (int k = rr; k < ks; k += RS) {
      const float4 s4 = *reinterpret_cast<const float4*>(ss + (k / QK) * TN + cgi * 4);
      const char4 w = *reinterpret_cast<const char4*>(wq + k * TN + cgi * 4);
      const float wv[4] = {round_to<T>(__fmul_rn((float)w.x, s4.x)),
                           round_to<T>(__fmul_rn((float)w.y, s4.y)),
                           round_to<T>(__fmul_rn((float)w.z, s4.z)),
                           round_to<T>(__fmul_rn((float)w.w, s4.w))};
      float xv[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m) xv[m] = to_f<T>(xt[m * ksx + k]);
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv[m], wv[c], acc[m][c]);
    }

    // the row slots of a warp, then the warps in order
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int o = CG; o < 32; o <<= 1)
          acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], o);
    if (lane < CG) {
#pragma unroll
      for (int m = 0; m < TM; ++m)
        *reinterpret_cast<float4*>(red + (warp * TM + m) * TN + cgi * 4) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
    __syncthreads();
    if (m0 == 0) cluster_wait();   // every block of the cluster runs
    for (int i = tid; i < TM * TN; i += THREADS) {
      const int m = i / TN, c = i % TN;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += red[(w * TM + m) * TN + c];
      *cluster.map_shared_rank(recv + (rank * TM + m) * cw + c % cw, c / cw) = s;
    }
    cluster.sync();
    // this block's columns: the cluster's partials in rank order
    for (int i = tid; i < TM * cw; i += THREADS) {
      const int m = i / cw, c = rank * cw + i % cw;
      if (c < TN && n0 + c < N && m0 + m < M) {
        float s = 0.f;
        for (int r = 0; r < ck; ++r) s += recv[(r * TM + m) * cw + i % cw];
        out[(size_t)(m0 + m) * N + n0 + c] = from_f<T>(s);
      }
    }
    if (m0 + TM < M) cluster.sync();   // recv, red and xt free for the next tile
  }
}

template <typename T, int TM, int TN, bool VEC>
int launch_kernel(const T* x, const int8_t* q, const float* scale, T* out,
                  int M, int K, int N, int ck, cudaStream_t stream) {
  const int nsb_max = (K / QK + ck - 1) / ck;
  const Layout L(TM, TN, nsb_max, ck);
  if (L.bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  static int allowed = 48 * 1024;   // per instantiation
  if (L.bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        q8_matmul_cluster_kernel<T, TM, TN, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = L.bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + TN - 1) / TN) * ck);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ck;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, q8_matmul_cluster_kernel<T, TM, TN, VEC>, x, q, scale, out, M, K,
      N, ck);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int TN, bool VEC>
int launch_tm(const T* x, const int8_t* q, const float* scale, T* out, int M,
              int K, int N, int ck, cudaStream_t s) {
  if (M <= 1) return launch_kernel<T, 1, TN, VEC>(x, q, scale, out, M, K, N, ck, s);
  if (M <= 2) return launch_kernel<T, 2, TN, VEC>(x, q, scale, out, M, K, N, ck, s);
  if (M <= 4) return launch_kernel<T, 4, TN, VEC>(x, q, scale, out, M, K, N, ck, s);
  if (M <= 8) return launch_kernel<T, 8, TN, VEC>(x, q, scale, out, M, K, N, ck, s);
  return launch_kernel<T, 16, TN, VEC>(x, q, scale, out, M, K, N, ck, s);
}

template <typename T>
int launch(const void* x, const void* q, const void* scale, void* out, int M,
           int K, int N, int tn, int ck, int vec, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* st = static_cast<const float*>(scale);
  T* ot = static_cast<T*>(out);
  if (tn == 32)
    return vec ? launch_tm<T, 32, true>(xt, qt, st, ot, M, K, N, ck, s)
               : launch_tm<T, 32, false>(xt, qt, st, ot, M, K, N, ck, s);
  return vec ? launch_tm<T, 64, true>(xt, qt, st, ot, M, K, N, ck, s)
             : launch_tm<T, 64, false>(xt, qt, st, ot, M, K, N, ck, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out). q int8 [K, N], scale f32
// [K/32, N], all row-major and contiguous; K a multiple of 32. tn: columns
// of a cluster's tile (32 or 64); ck: blocks of a cluster along K (1..8,
// at most K/32). vec = 1 when N is a multiple of 16 and x, q and scale are
// 16-byte aligned. Launches ceil(N/tn) clusters of ck blocks, one kernel.
// Returns the launch's CUDA error code (0 on success).
int q8_matmul_launch(int dtype, const void* x, const void* q, const void* scale,
                     void* out, int M, int K, int N, int tn, int ck, int vec,
                     void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % QK || (tn != 32 && tn != 64) ||
      ck < 1 || ck > MAXCK || ck > K / QK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, q, scale, out, M, K, N, tn, ck, vec, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, q, scale, out, M, K, N, tn, ck, vec, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
