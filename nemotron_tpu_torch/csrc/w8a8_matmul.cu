// Dynamic-activation int8 matmul (W8A8) for Hopper (sm_90a).
//
//   out[M, N] = (sum over K-groups t of (xq_t @ q_t)_int32 * s[m, t])
//               * col_scale[N]
//
// Replaces the Pallas TPU kernel `w8a8_matmul`
// (nemotron_tpu/ops/w8a8_kernel.py:52, body `_kernel` :29-48). Each row of
// x is quantized per K-group of G = w8a8_k_tile(K) columns (the TPU
// kernel's K tile: 1024, 512 or 256, else the whole row up to 1024):
// s = max(amax, 1e-12) * f32(1/127), xq = clip(rint(x / s), -127, 127).
// The group width is part of the function, so the tiling below is free to
// differ from it. Every float step is the plain version's, in its order
// (ops/w8a8_kernel.py:w8a8_matmul_ref): correctly rounded divide, rint
// (half to even), acc + f32(p) * s and acc * col_scale without FMA
// contraction, bf16 by round-to-nearest-even. The integer dot is exact, so
// the kernel equals its plain version bit for bit.
//
// What bounds it on the card: the streaming step calls it with a skinny M
// (8..112 rows for 8 streams; 568..672 for the shared x-ring's K/V
// recompute). One layer's ten matmuls read 24,117,248 weight bytes: 7.2 us
// at 3.35 TB/s. At M = 112 they are 5.4 G int8 operations, 2.7 us at the
// tensor cores' 1,979 TOPS. So it is bound by bytes.
//
// Design: three passes, all launched on the caller's stream.
//  1. quantize: one block per (row, group) finds the amax (as the unsigned
//     max of |x|'s bit patterns, which keeps a NaN: the scale becomes NaN
//     and so does every output of the row), writes s and xq into scratch.
//     The TPU kernel quantizes an [M, TK] tile in VMEM inside the matmul;
//     that tile does not fit in shared memory at M = 672, TK = 1024.
//  2. product: threads own 4 adjacent output columns (one 32-bit load of
//     q[k, n:n+4], coalesced along N); 4 rows are transposed with byte
//     permutes and fed to __dp4a against 4 packed xq bytes of each row.
//     Warps split the block's K rows; their int32 sums meet through shared
//     memory atomics (integer, so exact in any order). Blocks split N and
//     K, so that M <= 16 still puts 64-256 blocks on the card's 132 SMs
//     streaming weight bytes; each block's K rows lie in one group.
//  3. reduce: per output, the int32 partials of each group are added (exact),
//     then acc = acc + f32(p) * s in group order from 0, times col_scale.
// Tensor cores (mma.sync s8, wgmma) and fusing the quantize pass into the
// product are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TN = 32 * 4;          // output columns per block, 4 per lane
constexpr int KB_SMALL = 128;       // K rows per product block, M <= 16
constexpr int KB_LARGE = 512;       // K rows per product block, M > 16
constexpr int TM_MAX = 16;          // rows of x per product block
constexpr float INV_QMAX = (float)(1.0 / 127.0);

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

size_t round_up(size_t v, size_t m) { return (v + m - 1) / m * m; }

// K rows per product block: KB_LARGE only where it keeps each block inside
// one group (a single group, or groups that are multiples of it).
int k_block(int M, int K, int G) {
  const bool one_group = G == K;
  return (M > TM_MAX && (one_group || G % KB_LARGE == 0)) ? KB_LARGE : KB_SMALL;
}

struct Layout {
  size_t xq, s, part, total;
  int kb, n_kb, n_groups;
};

Layout layout(int M, int K, int N, int G) {
  Layout l;
  l.kb = k_block(M, K, G);
  l.n_kb = (K + l.kb - 1) / l.kb;
  l.n_groups = K / G;
  l.xq = 0;
  l.s = round_up((size_t)M * K, 256);
  l.part = l.s + round_up((size_t)M * l.n_groups * sizeof(float), 256);
  l.total = l.part + (size_t)l.n_kb * M * N * sizeof(int);
  return l;
}

// Pass 1: grid (M, n_groups). Scale and int8 values of one row's group.
template <typename T>
__global__ void __launch_bounds__(THREADS)
w8a8_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ s, int K, int G, int n_groups) {
  __shared__ unsigned warp_max[WARPS];
  __shared__ float scale_sh;
  const int m = blockIdx.x, t = blockIdx.y;
  const T* xr = x + (size_t)m * K + (size_t)t * G;
  unsigned amax = 0;   // |x| >= 0, so the bit patterns order as the values
  for (int k = threadIdx.x; k < G; k += THREADS)
    amax = max(amax, __float_as_uint(fabsf(to_f<T>(xr[k]))));
#pragma unroll
  for (int o = 16; o; o >>= 1) amax = max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned a = warp_max[0];
    for (int w = 1; w < WARPS; ++w) a = max(a, warp_max[w]);
    const float af = __uint_as_float(a);
    const float floored = (af >= 1e-12f || af != af) ? af : 1e-12f;  // NaN stays
    const float sc = __fmul_rn(floored, INV_QMAX);
    scale_sh = sc;
    s[(size_t)m * n_groups + t] = sc;
  }
  __syncthreads();
  const float sc = scale_sh;
  int8_t* xo = xq + (size_t)m * K + (size_t)t * G;
  for (int k = threadIdx.x; k < G; k += THREADS) {
    const float v = rintf(__fdiv_rn(to_f<T>(xr[k]), sc));
    xo[k] = (int8_t)(int)fminf(fmaxf(v, -127.f), 127.f);
  }
}

// Pass 2: grid (ceil(N/TN), n_kb, ceil(M/TM)). Block: columns
// [bx*TN, bx*TN+TN) x K rows [by*KB, by*KB+KB) x rows [bz*TM, bz*TM+TM);
// warp w takes K rows [w*KB/WARPS, (w+1)*KB/WARPS) of the block's slice.
template <int TM, int KB, bool VEC>
__global__ void __launch_bounds__(THREADS)
w8a8_product_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ q,
                    int* __restrict__ part, int M, int K, int N) {
  __shared__ __align__(16) int8_t xs[TM * KB];
  __shared__ int red[TM * TN];
  constexpr int KW = KB / WARPS;
  static_assert(KW % 4 == 0, "rows per warp must pack into dp4a words");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.y * KB;
  const int m0 = blockIdx.z * TM;
  const int n = blockIdx.x * TN + lane * 4;

  for (int i = threadIdx.x; i < TM * KB; i += THREADS) {
    const int m = i / KB, k = i % KB;
    int8_t v = 0;
    if (m0 + m < M && k0 + k < K) v = xq[(size_t)(m0 + m) * K + k0 + k];
    xs[i] = v;
  }
  for (int i = threadIdx.x; i < TM * TN; i += THREADS) red[i] = 0;
  __syncthreads();

  int acc[TM][4];
#pragma unroll
  for (int m = 0; m < TM; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0;

  if (n < N) {
#pragma unroll 2
    for (int r = 0; r < KW; r += 4) {
      const int kl = warp * KW + r;
      unsigned w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + kl + i;
        w[i] = 0;
        if (k < K) {
          const int8_t* src = q + (size_t)k * N + n;
          if (VEC) {
            w[i] = *reinterpret_cast<const unsigned*>(src);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (n + c < N) w[i] |= (unsigned)(uint8_t)src[c] << (8 * c);
          }
        }
      }
      // 4x4 byte transpose: col[c] packs q[k..k+3, n+c]
      const unsigned t0 = __byte_perm(w[0], w[1], 0x5140);
      const unsigned t1 = __byte_perm(w[2], w[3], 0x5140);
      const unsigned t2 = __byte_perm(w[0], w[1], 0x7362);
      const unsigned t3 = __byte_perm(w[2], w[3], 0x7362);
      const int col0 = (int)__byte_perm(t0, t1, 0x5410);
      const int col1 = (int)__byte_perm(t0, t1, 0x7632);
      const int col2 = (int)__byte_perm(t2, t3, 0x5410);
      const int col3 = (int)__byte_perm(t2, t3, 0x7632);
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const int xv = *reinterpret_cast<const int*>(xs + m * KB + kl);
        acc[m][0] = __dp4a(xv, col0, acc[m][0]);
        acc[m][1] = __dp4a(xv, col1, acc[m][1]);
        acc[m][2] = __dp4a(xv, col2, acc[m][2]);
        acc[m][3] = __dp4a(xv, col3, acc[m][3]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) atomicAdd(&red[m * TN + lane * 4 + c], acc[m][c]);
  __syncthreads();

  for (int i = threadIdx.x; i < TM * TN; i += THREADS) {
    const int m = i / TN, c = i % TN;
    const int gm = m0 + m, gn = blockIdx.x * TN + c;
    if (gm < M && gn < N) part[((size_t)blockIdx.y * M + gm) * N + gn] = red[i];
  }
}

// Pass 3: one thread per output. Group by group in order: the group's
// int32 partials summed (exact), then acc = acc + f32(p) * s.
template <typename T>
__global__ void w8a8_reduce_kernel(const int* __restrict__ part,
                                   const float* __restrict__ s,
                                   const float* __restrict__ col_scale,
                                   T* __restrict__ out, int M, int N,
                                   int n_groups, int kb_per_group) {
  const size_t MN = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  const int m = (int)(i / N), n = (int)(i % N);
  float acc = 0.f;
  for (int t = 0; t < n_groups; ++t) {
    int p = 0;
    for (int b = t * kb_per_group; b < (t + 1) * kb_per_group; ++b) p += part[b * MN + i];
    acc = __fadd_rn(acc, __fmul_rn((float)p, s[(size_t)m * n_groups + t]));
  }
  out[i] = from_f<T>(__fmul_rn(acc, col_scale[n]));
}

template <int TM, int KB, bool VEC>
void launch_product(const int8_t* xq, const int8_t* q, int* part, int M, int K,
                    int N, int n_kb, cudaStream_t stream) {
  const dim3 grid((N + TN - 1) / TN, n_kb, (M + TM - 1) / TM);
  w8a8_product_kernel<TM, KB, VEC><<<grid, THREADS, 0, stream>>>(xq, q, part, M, K, N);
}

template <bool VEC>
void product(const int8_t* xq, const int8_t* q, int* part, int M, int K, int N,
             const Layout& l, cudaStream_t stream) {
  if (l.kb == KB_LARGE) launch_product<16, KB_LARGE, VEC>(xq, q, part, M, K, N, l.n_kb, stream);
  else if (M <= 1) launch_product<1, KB_SMALL, VEC>(xq, q, part, M, K, N, l.n_kb, stream);
  else if (M <= 2) launch_product<2, KB_SMALL, VEC>(xq, q, part, M, K, N, l.n_kb, stream);
  else if (M <= 4) launch_product<4, KB_SMALL, VEC>(xq, q, part, M, K, N, l.n_kb, stream);
  else if (M <= 8) launch_product<8, KB_SMALL, VEC>(xq, q, part, M, K, N, l.n_kb, stream);
  else launch_product<16, KB_SMALL, VEC>(xq, q, part, M, K, N, l.n_kb, stream);
}

template <typename T>
int launch(const void* x, const void* q, const void* col_scale, void* scratch,
           void* out, int M, int K, int N, int G, int vec, cudaStream_t stream) {
  const Layout l = layout(M, K, N, G);
  char* base = static_cast<char*>(scratch);
  int8_t* xq = reinterpret_cast<int8_t*>(base + l.xq);
  float* s = reinterpret_cast<float*>(base + l.s);
  int* part = reinterpret_cast<int*>(base + l.part);
  const int8_t* qt = static_cast<const int8_t*>(q);

  w8a8_quantize_kernel<T><<<dim3(M, l.n_groups), THREADS, 0, stream>>>(
      static_cast<const T*>(x), xq, s, K, G, l.n_groups);
  if (vec) product<true>(xq, qt, part, M, K, N, l, stream);
  else product<false>(xq, qt, part, M, K, N, l, stream);
  const size_t MN = (size_t)M * N;
  const int kb_per_group = l.n_groups == 1 ? l.n_kb : G / l.kb;
  w8a8_reduce_kernel<T><<<(unsigned)((MN + 255) / 256), 256, 0, stream>>>(
      part, s, static_cast<const float*>(col_scale), static_cast<T*>(out), M, N,
      l.n_groups, kb_per_group);
  return (int)cudaGetLastError();
}

bool valid(int M, int K, int N, int G) {
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || G > 1024 || K % G) return false;
  return G == K || G % KB_SMALL == 0;
}

}  // namespace

extern "C" {

// Bytes of device scratch the caller allocates for one call: xq [M, K]
// int8, s [M, K/G] f32 and the int32 partial sums [K-blocks, M, N].
long w8a8_matmul_scratch_bytes(int M, int K, int N, int G) {
  if (!valid(M, K, N, G)) return 0;
  return (long)layout(M, K, N, G).total;
}

// dtype: 0 = float32, 1 = bfloat16 (x and out). q int8 [K, N], col_scale
// f32 [N], all row-major and contiguous; G the K-group width; vec = 1 when
// N % 4 == 0 and q is 4-byte aligned. Returns cudaGetLastError().
int w8a8_matmul_launch(int dtype, const void* x, const void* q,
                       const void* col_scale, void* scratch, void* out, int M,
                       int K, int N, int G, int vec, void* stream) {
  if (!valid(M, K, N, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, q, col_scale, scratch, out, M, K, N, G, vec, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, q, col_scale, scratch, out, M, K, N, G, vec, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
