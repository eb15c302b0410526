// Blockwise-int8 (GGUF Q8_0) weight matmul for Hopper (sm_90a).
//
//   out[M, N] = x[M, K] @ (q[K, N] * expand32(scale[K/32, N]))
//
// Replaces the Pallas TPU kernel `q8_matmul`
// (nemotron_tpu/ops/quant_kernel.py:58, body `_q8_matmul_kernel` :31-54).
// Numerics follow it: each weight is dequantized as (float)q * scale in f32,
// rounded to the ACTIVATION dtype (f32 or bf16), then multiplied into an f32
// accumulator (FFMA on the CUDA cores, no TF32). Q4_0 weights arrive here as
// int8 in [-8, 7] with a scale. Two designs share that arithmetic; the
// wrapper's `q8_launch_geometry` picks one from M (skinny up to a row count
// M* measured on the card, tiled above it). Both are one launch a call, use
// no workspace and no atomics, and give the same bits on every call.
//
// Skinny M (`q8_matmul_cluster_kernel`). The streaming step calls it with
// S * Q = 1..14 rows at one stream, so it is one pass over the weight:
// about 27 MB a layer (24.1 MB of int8, 3.0 MB of f32 scales), 8.1 us at
// 3.35 TB/s. At M = 14 in f32 the FMAs (14 per weight byte, 10.08 us a
// layer at 67 TFLOP/s) bound it first. To stream at HBM rate the card needs
// about 25 KB in flight per SM (Little's law at ~1 us of DRAM latency),
// and a grid of at least one wave; a split-K design needs the partial sums
// added without a second launch or a workspace.
//
// Its design: the grid is ceil(N / TN) column tiles of TN = 32 or 64
// columns, each a thread-block cluster of CK <= 8 blocks that split K by
// whole 32-row scale blocks (at least 132 blocks for every (K, N) of the
// encoder). Each block issues its whole K slice of the weight tile, its
// scales and its x rows ([m][k], in x's dtype) at once as 16-byte cp.async
// copies into shared memory, so the whole slice is in flight at once: 4-16
// KB of weight a block, 2-4 blocks an SM, up to 32 KB an SM. (Splitting the
// copies into several commit groups and computing on each as it lands was
// slower on the card: the groups land together and each wait costs a block
// barrier.) A block is 4 warps: at TM = 16 a thread holds 64 accumulators
// (about 110 registers), and 8-warp blocks halved the blocks an SM holds,
// so the clusters of a call no longer fitted in one wave. A thread owns 4
// columns (one 32-bit word of weights a row) and every RS-th row of the
// slice, for up to TM = 16 rows of x: it dequantizes each weight once in
// registers and does TM FMAs with it. The threads' partials are added with
// warp shuffles and then across the 4 warps in a fixed order; each block
// pushes its [TM, TN] partial tile into the shared memory of the cluster
// block that owns those columns (distributed shared memory), one cluster
// barrier, and each block adds its columns' partials in rank order and
// stores them. M above 16 loops over 16-row tiles inside the block, and
// that is what makes it slow at large M: every 16-row tile dequantizes the
// weight slice again, pays the shuffles, a block barrier, a DSMEM push and
// two cluster barriers for a few hundred FMAs a thread, and the grid does
// not grow with M.
//
// Large M (`q8_matmul_tiled_kernel`). The full-utterance encoder (M = 804)
// and the 64-slot engine (M = 896) make it a GEMM bound by the f32 FMAs:
// 645 us a layer at M = 896 (43.2 GFLOP at 67 TFLOP/s) against 8 us of
// weight bytes. What has to be kept off the FMA pipe is everything else:
// shared-memory loads, dequantization, barriers and idle SMs. On an H100 an
// SM's shared memory delivers about a quarter of a float a lane for each
// FFMA the SM can issue, so a thread's tile has to be large. The design is
// a tiled SIMT GEMM:
//  - a block computes a 128 x 128 output tile with 4 warps (2 x 2); a
//    thread holds 8 x 16 accumulators, rows ra + 8 i and columns cb + 16 g
//    + j, and per K row reads 8 x values and 16 weights (24 floats for 128
//    FFMAs): its x rows as float4 along K (one load covers 4 K rows; the
//    lanes of a column group read 8 neighbouring rows, conflict-free with a
//    16-byte row pad), its weights as 4 float4 along N;
//  - K is walked in steps of 32 rows, one scale block. A ring of 3 stages
//    in shared memory holds the raw tiles (x [128][32] in its dtype, K
//    contiguous as in device memory, so the compute reads x where it
//    landed; the int8 weights [32][128]; their 128 f32 scales), filled with
//    16-byte cp.async (zero-filled past M and N) two steps ahead;
//  - one step ahead of the compute, the block dequantizes the next step's
//    weights once into one of two f32 buffers [32][128] (rounded to x's
//    dtype), which every one of the 128 rows then reuses: each weight is
//    dequantized ceil(M / 128) times in all (7 at M = 896, where the skinny
//    design did it 56 times). One block barrier a step;
//  - the compute loop is unrolled by 4 of its 8 groups of 4 K rows: fully
//    unrolled, it overflows the instruction cache when an SM holds one
//    block;
//  - waves: the 128 x 128 tiles alone give 56 blocks at M = 896 for
//    N = 1024. A cluster of `split` blocks then splits K by whole scale
//    blocks (the least split that gives a block an SM); after the main
//    loop each block pushes its partial tile, a band of rows at a time,
//    into the shared memory of the block that owns the band (distributed
//    shared memory, after a cluster barrier that frees the ring), and each
//    owner adds the partials in rank order. One launch, no workspace, no
//    atomics, deterministic.
// 100 KB of shared memory a block in f32 (76 KB in bf16) and up to 255
// registers a thread: 2 blocks (8 warps) an SM.

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

// The same copy, zero-filling the 16 bytes when `in` is false (the source
// must still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* smem_dst,
                                                 const void* gmem_src, bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

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

// ---------------------------------------------------------------------------
// Large M: the tiled design
// ---------------------------------------------------------------------------

constexpr int TBM = 128;                 // rows of a block's output tile
constexpr int TBN = 128;                 // columns of a block's output tile
constexpr int TTHREADS = 128;            // 4 warps as 2 x 2
constexpr int TR = TBM / 16;             // rows a thread (x 16 columns)
constexpr int STAGES = 3;                // raw K steps in the copy ring

// Byte offsets of a tiled block's shared memory: the ring of raw K steps,
// then two f32 buffers of dequantized weights. After the main loop the
// partial tiles of a cluster land at offset 0 (f32 [split][TBM / split]
// [TBN], 64 KB).
template <typename T> struct Tiled {
  static constexpr int XS = QK + 16 / (int)sizeof(T);   // x row: 16 B pad
  static constexpr int X_BYTES = TBM * XS * (int)sizeof(T);
  static constexpr int W_BYTES = QK * TBN;              // int8 [32][TBN]
  static constexpr int S_BYTES = TBN * 4;               // f32 [TBN]
  static constexpr int STAGE = X_BYTES + W_BYTES + S_BYTES;
  static constexpr int WF = STAGES * STAGE;             // f32 [2][32][TBN]
  static constexpr int BYTES = WF + 2 * QK * TBN * 4;
  static constexpr int EPC = 16 / (int)sizeof(T);       // x elements a copy
  static constexpr int XC = QK / EPC;                   // copies an x row
  static_assert(STAGE % 16 == 0 && X_BYTES % 16 == 0, "16-byte copies");
  static_assert(TTHREADS % XC == 0 && TBM % 16 == 0, "x copies, rows");
  static_assert(BYTES >= TBM * TBN * 4, "room for the cluster's partials");
  static_assert(BYTES <= 227 * 1024, "shared memory of one block");
};

// Issue the copies of one K step (scale block sb) into a ring slot. VEC:
// 16-byte cp.async, zero-filled past M and N, a fixed number a thread;
// else plain loads and stores.
template <typename T, bool VEC>
__device__ __forceinline__ void tiled_load(unsigned char* slot,
                                           const T* __restrict__ x,
                                           const int8_t* __restrict__ q,
                                           const float* __restrict__ scale,
                                           int M, int K, int N, int m0,
                                           int n0, int sb, int tid) {
  using L = Tiled<T>;
  T* xr = reinterpret_cast<T*>(slot);
  int8_t* wr = reinterpret_cast<int8_t*>(slot + L::X_BYTES);
  float* sr = reinterpret_cast<float*>(slot + L::X_BYTES + L::W_BYTES);
  const int k0 = sb * QK;
  if constexpr (VEC) {
    const int xk = (tid % L::XC) * L::EPC;
#pragma unroll
    for (int j = 0; j < (TBM * L::XC + TTHREADS - 1) / TTHREADS; ++j) {
      const int m = tid / L::XC + j * (TTHREADS / L::XC);
      const bool in = m0 + m < M;
      if (m < TBM)
        cp_async16_zfill(xr + m * L::XS + xk,
                         x + (size_t)(in ? m0 + m : 0) * K + k0 + xk, in);
    }
    const int col = (tid % (TBN / 16)) * 16;
    const bool cin = n0 + col < N;
#pragma unroll
    for (int j = 0; j < QK * (TBN / 16) / TTHREADS; ++j) {
      const int r = tid / (TBN / 16) + j * (TTHREADS / (TBN / 16));
      cp_async16_zfill(wr + r * TBN + col,
                       q + (size_t)(k0 + r) * N + (cin ? n0 + col : 0), cin);
    }
    if (tid < TBN / 4) {
      const int c4 = tid * 4;
      const bool in = n0 + c4 < N;
      cp_async16_zfill(sr + c4, scale + (size_t)sb * N + (in ? n0 + c4 : 0),
                       in);
    }
  } else {
    for (int i = tid; i < TBM * QK; i += TTHREADS) {
      const int m = i / QK, k = i % QK;
      xr[m * L::XS + k] = m0 + m < M ? x[(size_t)(m0 + m) * K + k0 + k]
                                     : from_f<T>(0.f);
    }
    for (int i = tid; i < QK * TBN; i += TTHREADS) {
      const int r = i / TBN, col = i % TBN;
      wr[i] = n0 + col < N ? q[(size_t)(k0 + r) * N + n0 + col] : (int8_t)0;
    }
    for (int col = tid; col < TBN; col += TTHREADS)
      sr[col] = n0 + col < N ? scale[(size_t)sb * N + n0 + col] : 0.f;
  }
}

// Dequantize a ring slot's weights into an f32 buffer [32][TBN]: (float)q *
// scale in f32, rounded to T. A warp reads one weight row (128 bytes) and
// writes it whole (512 bytes).
template <typename T>
__device__ __forceinline__ void tiled_dequant(const unsigned char* slot,
                                              float* wf, int tid) {
  using L = Tiled<T>;
  const int8_t* wr = reinterpret_cast<const int8_t*>(slot + L::X_BYTES);
  const float* sr = reinterpret_cast<const float*>(slot + L::X_BYTES + L::W_BYTES);
  const int n = (tid % 32) * 4;
  const float4 s4 = *reinterpret_cast<const float4*>(sr + n);
#pragma unroll
  for (int j = 0; j < QK / (TTHREADS / 32); ++j) {
    const int k = tid / 32 + j * (TTHREADS / 32);
    const char4 w = *reinterpret_cast<const char4*>(wr + k * TBN + n);
    *reinterpret_cast<float4*>(wf + k * TBN + n) =
        make_float4(round_to<T>(__fmul_rn((float)w.x, s4.x)),
                    round_to<T>(__fmul_rn((float)w.y, s4.y)),
                    round_to<T>(__fmul_rn((float)w.z, s4.z)),
                    round_to<T>(__fmul_rn((float)w.w, s4.w)));
  }
}

// x[row][k .. k+3] of a ring slot as f32: one 16-byte load in f32, one
// 8-byte load widened exactly in bf16 (two values a word, the first in the
// low half).
template <typename T> __device__ __forceinline__ float4 x4(const T* p);
template <> __device__ __forceinline__ float4 x4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 x4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Store 4 neighbouring outputs of one row (VEC: N % 16 == 0, so a group of
// 4 columns is wholly in or out, and the store is one vector).
template <typename T, bool VEC>
__device__ __forceinline__ void store4(T* __restrict__ out, int M, int N,
                                       int row, int col, float4 v) {
  if (row >= M) return;
  T* dst = out + (size_t)row * N + col;
  if constexpr (VEC) {
    if (col >= N) return;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const auto bits = [](float f) {
        return (unsigned)__bfloat16_as_ushort(from_f<T>(f));
      };
      *reinterpret_cast<uint2*>(dst) = make_uint2(
          bits(v.x) | bits(v.y) << 16, bits(v.z) | bits(v.w) << 16);
    }
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < N) dst[j] = from_f<T>(e[j]);
  }
}

// Grid: (ceil(N / TBN) * split, ceil(M / TBM)) blocks in clusters of
// `split` along x; the blocks of a cluster split K by whole scale blocks.
// A thread owns rows ra + 8 i (i < TR) and columns cb + 16 g + j (g, j <
// 4): per K row it reads TR x values (one float4 covers 4 K rows of a row;
// the lanes of a column group read neighbouring rows, conflict-free with
// the 16-byte row pad) and 16 weights (4 float4), for 16 TR FFMAs.
template <typename T, bool VEC>
__global__ void __launch_bounds__(TTHREADS, 2)
q8_matmul_tiled_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, T* __restrict__ out,
                       int M, int K, int N, int split) {
  using L = Tiled<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / split) * TBN, m0 = blockIdx.y * TBM;
  const int nsb = K / QK;
  const int sb0 = rank * nsb / split;
  const int steps = (rank + 1) * nsb / split - sb0;
  float* wf = reinterpret_cast<float*>(smem + L::WF);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ra = (warp >> 1) * (TBM / 2) + (lane >> 2);   // rows ra + 8 i
  const int cb = (warp & 1) * 64 + (lane & 3) * 4;     // cols cb + 16 g + j

  // raw steps 0 and 1 in flight; step 0's weights dequantized
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < steps)
      tiled_load<T, VEC>(smem + s * L::STAGE, x, q, scale, M, K, N, m0, n0,
                         sb0 + s, tid);
    cp_async_commit();
  }
  cp_async_wait<1>();
  __syncthreads();
  if (steps > 0) tiled_dequant<T>(smem, wf, tid);
  float acc[TR][16];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < steps; ++kt) {
    // raw step kt+1 has landed and step kt's weights are dequantized; every
    // thread is done with step kt-1 (its ring slot and weight buffer)
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 2 < steps)
      tiled_load<T, VEC>(smem + ((kt + 2) % STAGES) * L::STAGE, x, q, scale,
                         M, K, N, m0, n0, sb0 + kt + 2, tid);
    cp_async_commit();
    if (kt + 1 < steps)
      tiled_dequant<T>(smem + ((kt + 1) % STAGES) * L::STAGE,
                       wf + ((kt + 1) & 1) * QK * TBN, tid);
    const T* xs = reinterpret_cast<const T*>(smem + (kt % STAGES) * L::STAGE) +
                  ra * L::XS;
    const float* ws = wf + (kt & 1) * QK * TBN + cb;
#pragma unroll 4
    for (int k4 = 0; k4 < QK; k4 += 4) {
      float4 a[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = x4<T>(xs + 8 * i * L::XS + k4);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const float* wk = ws + (k4 + kq) * TBN;
        float b[16];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(wk + 16 * g);
          b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float av = kq == 0 ? a[i].x : kq == 1 ? a[i].y
                         : kq == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }

  if (split == 1) {
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        store4<T, VEC>(out, M, N, m0 + ra + 8 * i, n0 + cb + 16 * g,
                       make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                                   acc[i][4 * g + 2], acc[i][4 * g + 3]));
    return;
  }
  // split K: block r owns rows [r * rp, (r + 1) * rp) of the tile; each
  // block pushes its partial rows to their owner's shared memory, slot
  // [rank][row][col], once every block of the cluster is past its loop
  const int rp = TBM / split;
  float* recv = reinterpret_cast<float*>(smem);
  cp_async_wait_all();
  cluster.sync();
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = ra + 8 * i;
    float* dst = cluster.map_shared_rank(recv, row / rp) +
                 (rank * rp + row % rp) * TBN + cb;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      *reinterpret_cast<float4*>(dst + 16 * g) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]);
  }
  cluster.sync();
  // this block's rows: the cluster's partials in rank order
  for (int c = tid; c < rp * (TBN / 4); c += TTHREADS) {
    const int lr = c / (TBN / 4), col = (c % (TBN / 4)) * 4;
    float4 s = *reinterpret_cast<const float4*>(recv + lr * TBN + col);
    for (int r = 1; r < split; ++r) {
      const float4 p = *reinterpret_cast<const float4*>(recv + (r * rp + lr) * TBN + col);
      s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
    }
    store4<T, VEC>(out, M, N, m0 + rank * rp + lr, n0 + col, s);
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
              int K, int N, int tm, int ck, cudaStream_t s) {
  switch (tm) {
    case 1: return launch_kernel<T, 1, TN, VEC>(x, q, scale, out, M, K, N, ck, s);
    case 2: return launch_kernel<T, 2, TN, VEC>(x, q, scale, out, M, K, N, ck, s);
    case 4: return launch_kernel<T, 4, TN, VEC>(x, q, scale, out, M, K, N, ck, s);
    case 8: return launch_kernel<T, 8, TN, VEC>(x, q, scale, out, M, K, N, ck, s);
    case 16: return launch_kernel<T, 16, TN, VEC>(x, q, scale, out, M, K, N, ck, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool VEC>
int launch_tiled(const T* x, const int8_t* q, const float* scale, T* out,
                 int M, int K, int N, int split, cudaStream_t stream) {
  using L = Tiled<T>;
  static bool allowed = false;   // per instantiation
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        q8_matmul_tiled_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + TBN - 1) / TBN) * split, (M + TBM - 1) / TBM);
  cfg.blockDim = dim3(TTHREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, q8_matmul_tiled_kernel<T, VEC>, x, q, scale, out, M, K, N, split);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* q, const void* scale, void* out, int M,
           int K, int N, int design, int tm, int tn, int ck, int vec,
           cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* st = static_cast<const float*>(scale);
  T* ot = static_cast<T*>(out);
  if (design == 1)
    return vec ? launch_tiled<T, true>(xt, qt, st, ot, M, K, N, ck, s)
               : launch_tiled<T, false>(xt, qt, st, ot, M, K, N, ck, s);
  if (tn == 32)
    return vec ? launch_tm<T, 32, true>(xt, qt, st, ot, M, K, N, tm, ck, s)
               : launch_tm<T, 32, false>(xt, qt, st, ot, M, K, N, tm, ck, s);
  return vec ? launch_tm<T, 64, true>(xt, qt, st, ot, M, K, N, tm, ck, s)
             : launch_tm<T, 64, false>(xt, qt, st, ot, M, K, N, tm, ck, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out). q int8 [K, N], scale f32
// [K/32, N], all row-major and contiguous; K a multiple of 32. design 0,
// skinny M: tm rows a block takes at once (1, 2, 4, 8 or 16), tn columns
// of a cluster's tile (32 or 64), ck blocks of a cluster along K (1..8, at
// most K/32); launches ceil(N/tn) clusters. design 1, large M: tm = 128
// and tn = 128, the output tile; ck = 1, 2, 4 or 8 blocks of a cluster
// along K (at most K/32); launches ceil(M/128) x ceil(N/128) clusters.
// vec = 1 when N is a multiple of 16 and x, q and scale are 16-byte
// aligned. One kernel; returns the launch's CUDA error code (0 on
// success).
int q8_matmul_launch(int dtype, const void* x, const void* q, const void* scale,
                     void* out, int M, int K, int N, int design, int tm,
                     int tn, int ck, int vec, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % QK || ck < 1 || ck > MAXCK ||
      ck > K / QK)
    return (int)cudaErrorInvalidValue;
  if (design == 0 ? (tn != 32 && tn != 64)
                  : (design != 1 || tm != TBM || tn != TBN || (ck & (ck - 1)) ||
                     (M + TBM - 1) / TBM > 65535))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, q, scale, out, M, K, N, design, tm, tn, ck, vec,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, q, scale, out, M, K, N, design, tm, tn,
                                 ck, vec, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
