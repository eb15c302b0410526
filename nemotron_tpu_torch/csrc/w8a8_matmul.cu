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
// (half to even), acc + f32(p) * s group by group from t = 0 and
// acc * col_scale without FMA contraction, bf16 by round-to-nearest-even.
// The amax is the unsigned max of |x|'s bit patterns, which keeps a NaN
// (the scale becomes NaN and so does every output of the row). The integer
// dot is exact, so the kernel equals its plain version bit for bit.
//
// Static mode (SmoothQuant's calibrated activation scale, the JAX package's
// qmm_w8a8 with act_scale, nemotron_tpu/ops/quant.py:137-148, which its
// Pallas kernel refuses): a scalar s read from device memory replaces the
// amax stage, xq = clip(rint(x / s), -127, 127) with x / s correctly
// rounded (the fast product x * f32(1/s) is taken only where it cannot
// round otherwise, as below, and clipped), no K grouping: the int32
// partials of every block are added as int32 (exact: |acc| <= 127 * 127 *
// 4096 < 2^31; f32 partials would not be above 2^24), and
// out = f32(acc) * (s * col_scale[n]), the product in parentheses first.
// One launch a call, as the dynamic mode.
//
// Two designs compute that function; the wrapper's `w8a8_launch_geometry`
// picks one from M (skinny up to a row count M* measured on the card, tiled
// above it). Both are one launch a call, use no workspace in device memory
// and no atomics, and give the same bits on every call.
//
// Skinny M (`w8a8_matmul_cluster_kernel`). The streaming step calls it with
// 8..112 rows for 8 streams. One layer's ten matmuls read 24,117,248 weight
// bytes: 7.2 us at 3.35 TB/s. At M = 112 they are 5.4 G int8 operations,
// 2.7 us on the tensor cores at 1,979 TOPS (46 us on __dp4a). So it is
// bound by bytes up to M ~ 112, and by the per-launch floor at M <= 16,
// where 82% of the main path's calls fall.
//
// Its design: the grid is ceil(N / BN) column tiles of BN = 32 or 64 columns
// (64 above 16 rows, since every column tile quantizes its own copy of x,
// and wherever a wave of blocks stays full), each a thread-block cluster of
// C <= 8 blocks along K: C = n_groups * c, c the largest power of two that
// keeps each block's slice of KS = K / C rows a multiple of 32 inside one
// group (KS = 128 at K = 1024, 512 at K = 4096; a single group that holds
// no multiple of 32 runs with C = 1, padded with zero bytes). Along y, one
// cluster for each M tile of BM = 16, 32 or 64 rows (BM halved while two
// blocks would not fit an SM; 4 warps at BM = 16, else 8). Each block:
//  1. issues its [KS][BN] weight slice and its [BM][KS] x tile as 16-byte
//     cp.async copies at once; each row's amax over the block's slice is
//     pushed into every block of the cluster (distributed shared memory);
//     the weights are transposed, with 4x4 byte permutes, into
//     [BN][KS + 16] (k contiguous, rows padded against bank conflicts);
//     one cluster barrier;
//  2. takes each group's max over the group's blocks (a max is exact in
//     any order) and computes s;
//  3. quantizes its slice into xq [BM][KS + 16] int8: x * f32(1/s) in a
//     loop without branches or conversion instructions, then the correctly
//     rounded divide for the few chunks where that lands within 1e-3 of a
//     half-integer (the same integers; the divide on every element made
//     the call up to 1.8x slower on an H100);
//  4. runs mma.sync.m16n8k32 s8 x s8 -> s32 over the slice, each warp for
//     16 rows and BN / (warps along N) columns;
//  5. pushes its int32 partial tile into the shared memory of the block
//     that owns those columns; one cluster barrier;
//  6. as owner, adds each group's int32 partials (exact in any order),
//     runs the ordered f32 group loop and stores.
// From M = 56 on, the x passes (copy from L2, amax, quantize), which every
// 64-column tile repeats for its own columns, and the cluster barriers
// take most of its time, not the weight bytes or the tensor cores: a
// layer at M = 896 (the 64-slot engine) took 1.6x torch._int_mm (H100).
//
// Large M (`w8a8_matmul_tiled_kernel`). The 64-slot engine (M = 896), the
// full-utterance batch (804) and the 256-slot engine (3584) make it a GEMM:
// 41 G int8 operations a layer at M = 896, 21 us on the tensor cores,
// against 25 us of bytes. What has to be kept small is everything around
// the products: quantizing x again for every column tile, barriers, and
// blocks with little work, and latency with one block an SM. The design
// is a tiled GEMM on mma.sync:
//  - a block computes a 128 x 128 output tile with 16 warps (4 x 4), each
//    warp 32 x 32 outputs (8 m16n8 tiles, 32 int32 accumulators a thread),
//    and walks its whole K range in steps of 64 rows. 16 warps, not 8: at
//    8 an SM scheduler had two warps to hide the quantize chains, the
//    shared-memory loads and the mma behind, and measured slower (H100;
//    at 16, 128 registers and no spills);
//  - a ring of 6 stages (3 in f32) in shared memory holds the raw steps
//    (x [128][64] in its dtype, rows padded by 16 bytes; the int8 weights
//    [64][128] with swizzled 16-byte chunks), filled by 16-byte cp.async,
//    zero-filled past M and N, four steps ahead (one in f32);
//  - one step ahead of the products, the block converts the next raw step
//    into one of two int8 tile pairs: x quantized with its row's scale into
//    A [128][64 + 16] (the fast product, then the divide for elements near
//    a half-integer; eight lanes a row), the weights transposed into B
//    [128][64 + 16] (k contiguous). Every x element is quantized once a
//    block for 128 columns (ceil(N / 128) times a call, where the skinny
//    design quantizes it ceil(N / 64) times), every weight byte transposed
//    once for 128 rows. One block barrier a step;
//  - dynamic mode: before the loop, each row's amax over each group the
//    block covers, read from L2 while the first steps are in flight by a
//    cluster of up to 8 neighbouring column tiles, each over 1 / cn of the
//    columns, the partial maxima exchanged through distributed shared
//    memory (read by every column tile alone, this pass read x from L2 as
//    often as the main loop does); each row's reciprocal scale once. At the end of each group the int32
//    accumulators fold into f32 ones, acc = acc + f32(p_t) * s_t in group
//    order. Static mode: one int32 sum;
//  - waves: 128 x 128 tiles give 56 blocks at M = 896 for N = 1024. A
//    cluster of `split` blocks then splits K, each block inside one group
//    (the least split that gives a block an SM): after the loop each block
//    pushes its int32 partial tile, a band of rows at a time, to the band's
//    owner, which adds each group's partials (exact in any order) and runs
//    the f32 group loop in order. (Fewer blocks than SMs measured faster:
//    one wave of 112 blocks beat two of 224; PERF.md.)
// 220 KB of shared memory a block in bf16 (190 KB in f32) and 128
// registers a thread: one block (16 warps) an SM.
// Left for later: wgmma and TMA (multicast of the x tile to a cluster's
// column tiles), a warp's near-half-integer divides shared out over its
// lanes without spilling at 128 registers, q/k/v in one call (one read of
// x for three weights), and programmatic dependent launch against the
// launch floor.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// threads of a block: 4 warps for 16-row tiles, 8 for larger ones (the x
// passes and the epilogue wait on latency, which more warps hide; 16 warps
// were slower)
template <int BM> __host__ __device__ constexpr int threads_of() {
  return BM == 16 ? 128 : 256;
}
constexpr int MAXC = 8;              // the portable cluster size
constexpr int KSTEP = 32;            // K depth of one mma.m16n8k32
constexpr int PAD = 16;              // bytes of padding per shared-memory row
constexpr int TWO_PER_SM = 113 * 1024;  // shared memory of a block, two an SM
constexpr float INV_QMAX = (float)(1.0 / 127.0);

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

// 16 bytes, or 16 zero bytes where `in` is false (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16_zfill(void* smem_dst, const void* gmem_src,
                                                 bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every cp.async of the thread, committed or not
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d += a (16x32 s8, row-major fragment) * b (32x8 s8, column-major fragment)
__device__ __forceinline__ void mma_s8(int* d, const unsigned* a, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// 4 consecutive elements at p (aligned to 4 elements) as f32.
template <typename T> __device__ __forceinline__ void load4(const T* p, float* v);
template <> __device__ __forceinline__ void load4<float>(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
template <> __device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                 float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);   // bf16 -> f32 is exact
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

// An integer-valued r clipped to [-127, 127], as the byte of an int8.
__device__ __forceinline__ unsigned clip8(float r) {
  return (unsigned)(uint8_t)(int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
}

// The quantized bytes of 4 values of a row with a finite scale s, packed:
// rint(v / s) with v / s correctly rounded, from y = v * rs (rs =
// f32(1 / s)). Dynamic mode: |v| <= amax, so |v / s| <= 127 * (1 + 2^-22):
// the integer lies in [-127, 127] with no clip, and y lies within 2.3e-5
// of the rounded quotient, so where y is at least 1e-3 from a half-integer
// both round to the same integer. Static mode (CLIP): y is first clipped
// to [-127, 127]; where |v / s| >= 127 either way gives 127, and below it
// the same bound holds. Returns whether any of the 4 is closer than that:
// the caller then takes exact4 (as for every chunk of a row whose s is NaN
// or infinite). Rounding adds and subtracts 1.5 * 2^23, which leaves the
// integer in the low bits of the sum: no conversion instruction (they run
// at an eighth of the FMA rate).
template <bool CLIP>
__device__ __forceinline__ bool fast4(const float* v, float rs, unsigned* packed) {
  constexpr float MAGIC = 12582912.0f;   // 1.5 * 2^23: RNE to an integer
  bool near = false;
  unsigned b[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float y = __fmul_rn(v[c], rs);
    if (CLIP) y = fminf(fmaxf(y, -127.f), 127.f);
    const float t = __fadd_rn(y, MAGIC);
    near |= fabsf(__fsub_rn(y, __fsub_rn(t, MAGIC))) > 0.499f;
    b[c] = __float_as_uint(t);           // low byte: rint(y) as an int8
  }
  *packed = __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040),
                        0x5410);
  return near;
}

__device__ __forceinline__ unsigned exact4(const float* v, float s) {
  unsigned p = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) p |= clip8(rintf(__fdiv_rn(v[c], s))) << (8 * c);
  return p;
}

// One thread's chunks of a row of x (cpt chunks of 4 from chunk j0 on,
// cyclically) quantized with scale sc into qr: a loop without branches
// over the chunks, then the correctly rounded divide for the few chunks
// with a quotient near a half-integer (bit j % 64 of `near` marks chunk j).
// CLIP: the static mode's clip of quotients beyond 127.
template <typename T, bool CLIP>
__device__ __forceinline__ void quantize_row(const T* xr, int8_t* qr, float sc,
                                             int cpt, int j0) {
  const float rs = __frcp_rn(sc);
  unsigned long long near = isfinite(sc) ? 0ull : ~0ull;
  int j = j0;
#pragma unroll 4
  for (int n = 0; n < cpt; ++n) {
    float v[4];
    load4<T>(xr + j * 4, v);
    unsigned packed;
    near |= (unsigned long long)fast4<CLIP>(v, rs, &packed) << (j & 63);
    *reinterpret_cast<unsigned*>(qr + j * 4) = packed;
    j = j + 1 == cpt ? 0 : j + 1;
  }
  while (near) {
    const int b = __ffsll((long long)near) - 1;
    near &= near - 1;
    for (int jj = b; jj < cpt; jj += 64) {
      float v[4];
      load4<T>(xr + jj * 4, v);
      *reinterpret_cast<unsigned*>(qr + jj * 4) = exact4(v, sc);
    }
  }
}

// Byte offsets of one block's shared memory.
struct Layout {
  int wt, xq, xs, recv, amax, scale, cs, bytes;
  __host__ __device__ Layout(int BM, int BN, int ksp, int C, int n_groups, int xsz) {
    const int row = ksp + PAD, cw = (BN + C - 1) / C;
    const int xq_bytes = BM * row > ksp * BN ? BM * row : ksp * BN;
    wt = 0;                                        // int8 [BN][row]
    xq = wt + BN * row;                            // int8 [BM][row] (first
                                                   // the staging [ksp][BN])
    xs = xq + (xq_bytes + 15) / 16 * 16;           // x [BM][ksp]
    recv = xs + BM * ksp * xsz;                    // int32 [C][BM][cw]
    amax = recv + (C * BM * cw * 4 + 15) / 16 * 16;  // u32 [C][BM]
    scale = amax + C * BM * 4;                     // f32 [n_groups][BM]
    cs = scale + (n_groups * BM * 4 + 15) / 16 * 16;  // f32 [cw]
    bytes = cs + (cw * 4 + 15) / 16 * 16;
  }
};

// x[m0:m0+BM, k0:k0+ks] -> xs [BM][ksp], zero past M and past the slice.
// vec: 16-byte cp.async (K * sizeof(T) % 16 == 0 and x 16-byte aligned).
template <typename T, int BM, int THREADS>
__device__ __forceinline__ void load_x_tile(const T* __restrict__ x, T* xs, int m0,
                                            int M, int K, int k0, int ks, int ksp,
                                            bool vec, int tid) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(T);
    const int cpr = ksp / EPC;                     // 16-byte chunks a row
    const int dm = THREADS / cpr, dk = THREADS % cpr;
    for (int m = tid / cpr, kc = tid % cpr; m < BM; m += dm) {
      const int k = kc * EPC;
      T* dst = xs + m * ksp + k;
      if (m0 + m < M && k < ks) cp_async16(dst, x + (size_t)(m0 + m) * K + k0 + k);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      kc += dk;
      if (kc >= cpr) { kc -= cpr; ++m; }
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < BM * ksp; i += THREADS) {
      const int m = i / ksp, k = i % ksp;
      xs[i] = m0 + m < M && k < ks ? x[(size_t)(m0 + m) * K + k0 + k] : from_f<T>(0.f);
    }
  }
}

// Grid: ceil(N / BN) * C blocks in clusters of C along K, times
// ceil(M / BM) along y (one M tile a cluster). Block r of a cluster takes
// K rows [r*ks, (r+1)*ks) (ks = K / C, padded to ksp, a multiple of 32,
// with zeros), all inside group r / (C / n_groups). act_scale: null for
// the dynamic mode, else the static mode's scalar s in device memory.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(threads_of<BM>())
w8a8_matmul_cluster_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                           const float* __restrict__ col_scale,
                           const float* __restrict__ act_scale,
                           T* __restrict__ out, int M, int K, int N, int C,
                           int ks, int ksp, int n_groups, int vec_x, int vec_w) {
  constexpr int THREADS = threads_of<BM>();
  constexpr int NW = THREADS / 32;
  constexpr int RW = BM / 16;          // warps along M
  constexpr int CWN = NW / RW;         // warps along N
  constexpr int WN = BN / CWN;         // columns of a warp
  constexpr int NT = WN / 8;           // its n8 tiles
  constexpr int TPR = THREADS / BM;    // threads a row in the x passes
  static_assert(RW * CWN == NW && NT >= 1 && WN % 8 == 0, "warp tiling");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / C) * BN;
  const int m0 = blockIdx.y * BM;          // the cluster's M tile
  const int k0 = rank * ks;
  const int per_group = C / n_groups;      // blocks of a group
  const int grp = rank / per_group;
  const int cw = (BN + C - 1) / C;         // output columns a block owns
  const int row = ksp + PAD;
  const Layout L(BM, BN, ksp, C, n_groups, sizeof(T));
  int8_t* wt = reinterpret_cast<int8_t*>(smem + L.wt);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + L.xq);
  int8_t* stage = xq;                      // until the transpose
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  int* recv = reinterpret_cast<int*>(smem + L.recv);
  unsigned* amax_sh = reinterpret_cast<unsigned*>(smem + L.amax);
  float* scale_sh = reinterpret_cast<float*>(smem + L.scale);
  float* cs_sh = reinterpret_cast<float*>(smem + L.cs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool stat = act_scale != nullptr;
  // the x passes: thread (xm, seg) takes chunks [seg*cpt, (seg+1)*cpt) of
  // 4 elements of row xm, starting at chunk j0, which spreads the 32 lanes
  // of a warp evenly over the banks
  const int xm = tid / TPR, seg = tid % TPR, cpt = ksp / 4 / TPR;
  const int j0 = (xm + seg * (32 / TPR)) % cpt;

  // the block's weight slice q[k0:k0+ks, n0:n0+BN] -> stage [ksp][BN],
  // zero past the slice and past N, and the x tile, all in flight
  if (vec_w) {
    for (int c = tid; c < ksp * (BN / 16); c += THREADS) {
      const int r = c / (BN / 16), col = (c % (BN / 16)) * 16;
      int8_t* dst = stage + r * BN + col;
      if (r < ks && n0 + col < N) cp_async16(dst, q + (size_t)(k0 + r) * N + n0 + col);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = tid; i < ksp * BN; i += THREADS) {
      const int r = i / BN, col = i % BN;
      stage[i] = r < ks && n0 + col < N ? q[(size_t)(k0 + r) * N + n0 + col]
                                        : (int8_t)0;
    }
  }
  load_x_tile<T, BM, THREADS>(x, xs, m0, M, K, k0, ks, ksp, vec_x, tid);
  for (int i = tid; i < cw; i += THREADS) {
    const int c = rank * cw + i;
    if (c < BN && n0 + c < N) cp_async4(cs_sh + i, col_scale + n0 + c);
    else cs_sh[i] = 0.f;
  }

  const int wr = warp / CWN, wc = warp % CWN;
  const int g = lane >> 2, t4 = lane & 3;
  cp_async_wait_all();
  __syncthreads();
  // 1. row amax over this block's slice, pushed into every block of the
  //    cluster (dynamic mode)
  if (!stat) {
    unsigned amax = 0;   // |x| >= 0, so the bit patterns order as the values
    const T* xr = xs + xm * ksp + seg * cpt * 4;
    int j = j0;
#pragma unroll 4
    for (int n = 0; n < cpt; ++n) {
      float v[4];
      load4<T>(xr + j * 4, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) amax = max(amax, __float_as_uint(fabsf(v[c])));
      if (++j == cpt) j = 0;
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1)
      amax = max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    for (int r = seg; r < C; r += TPR)
      *cluster.map_shared_rank(amax_sh + rank * BM + xm, r) = amax;
  }
  {
    // the weights have landed: stage [ksp][BN] -> wt [BN][row], 4x4
    // blocks of bytes, before xq (which aliases the staging) is written
    for (int i = tid; i < (ksp / 4) * (BN / 4); i += THREADS) {
      const int n4 = (i % (BN / 4)) * 4, k4 = (i / (BN / 4)) * 4;
      unsigned w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = *reinterpret_cast<const unsigned*>(stage + (k4 + r) * BN + n4);
      // col[c] packs q[k4..k4+3, n4+c]
      const unsigned t0 = __byte_perm(w[0], w[1], 0x5140);
      const unsigned t1 = __byte_perm(w[2], w[3], 0x5140);
      const unsigned t2 = __byte_perm(w[0], w[1], 0x7362);
      const unsigned t3 = __byte_perm(w[2], w[3], 0x7362);
      const unsigned col[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                               __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<unsigned*>(wt + (n4 + c) * row + k4) = col[c];
    }
  }
  cluster.sync();
  // 2. each group's scale per row: the max over the group's blocks, or
  //    the static scale
  const float s_static = stat ? __ldg(act_scale) : 0.f;
  for (int i = tid; i < n_groups * BM; i += THREADS) {
    if (stat) {
      scale_sh[i] = s_static;
      continue;
    }
    const int t = i / BM, m = i % BM;
    unsigned a = 0;
    for (int r = t * per_group; r < (t + 1) * per_group; ++r)
      a = max(a, amax_sh[r * BM + m]);
    const float af = __uint_as_float(a);
    const float floored = (af >= 1e-12f || af != af) ? af : 1e-12f;  // NaN stays
    scale_sh[i] = __fmul_rn(floored, INV_QMAX);
  }
  __syncthreads();
  // 3. quantize this block's slice into xq [BM][row]
  {
    const float sc = scale_sh[grp * BM + xm];
    const T* xr = xs + xm * ksp + seg * cpt * 4;
    int8_t* qr = xq + xm * row + seg * cpt * 4;
    if (stat) quantize_row<T, true>(xr, qr, sc, cpt, j0);
    else quantize_row<T, false>(xr, qr, sc, cpt, j0);
  }
  __syncthreads();
  // 4. int32 products on the tensor cores: warp (wr, wc) takes rows
  //    [wr*16, wr*16+16) and columns [wc*WN, wc*WN+WN) of the tile
  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  {
    const int8_t* a_lo = xq + (wr * 16 + g) * row + 4 * t4;
    const int8_t* a_hi = a_lo + 8 * row;
    const int8_t* b_p = wt + (wc * WN + g) * row + 4 * t4;
    for (int kk = 0; kk < ksp; kk += KSTEP) {
      const unsigned a[4] = {ld32(a_lo + kk), ld32(a_hi + kk), ld32(a_lo + kk + 16),
                             ld32(a_hi + kk + 16)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* bp = b_p + j * 8 * row + kk;
        mma_s8(acc[j], a, ld32(bp), ld32(bp + 16));
      }
    }
  }
  // 5. the partial tile to the blocks that own its columns (two adjacent
  //    columns a store where a block owns an even count)
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wr * 16 + g + h * 8;
      const int c = wc * WN + j * 8 + 2 * t4;
      int* dst = recv + (rank * BM + m) * cw + c % cw;
      if (cw % 2 == 0) {
        *reinterpret_cast<int2*>(cluster.map_shared_rank(dst, c / cw)) =
            make_int2(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        *cluster.map_shared_rank(dst, c / cw) = acc[j][2 * h];
        const int c1 = c + 1;
        *cluster.map_shared_rank(recv + (rank * BM + m) * cw + c1 % cw, c1 / cw) =
            acc[j][2 * h + 1];
      }
    }
  cluster.sync();
  // 6. this block's columns: each group's partials (int32, exact), then
  //    the f32 group loop in order; static mode: every block's partials
  //    as one int32 sum, then f32(acc) * (s * col_scale)
  for (int i = tid; i < BM * cw; i += THREADS) {
    const int m = i / cw, cc = i % cw, c = rank * cw + cc;
    if (stat && c < BN && n0 + c < N && m0 + m < M) {
      const int* pr = recv + m * cw + cc;
      int p = 0;
#pragma unroll
      for (int r = 0; r < MAXC; ++r)
        if (r < C) p += pr[r * BM * cw];
      out[(size_t)(m0 + m) * N + n0 + c] =
          from_f<T>(__fmul_rn((float)p, __fmul_rn(s_static, cs_sh[cc])));
    } else if (c < BN && n0 + c < N && m0 + m < M) {
      float a = 0.f;
      for (int t = 0; t < n_groups; ++t) {
        const int* pr = recv + (t * per_group * BM + m) * cw + cc;
        int p = 0;
#pragma unroll
        for (int r = 0; r < MAXC; ++r)
          if (r < per_group) p += pr[r * BM * cw];
        a = __fadd_rn(a, __fmul_rn((float)p, scale_sh[t * BM + m]));
      }
      out[(size_t)(m0 + m) * N + n0 + c] = from_f<T>(__fmul_rn(a, cs_sh[cc]));
    }
  }
}

// ---------------------------------------------------------------------------
// Large M: the tiled design
// ---------------------------------------------------------------------------

constexpr int TBM = 128;          // rows of a block's output tile
constexpr int TBN = 128;          // columns of a block's output tile
constexpr int TBK = 64;           // K rows of one pipeline step
constexpr int TWARPS = 16;        // warps of a block: 4 along M x 4 along N
constexpr int TTHREADS = 32 * TWARPS;
constexpr int WGN = 4;            // warps along N, 32 columns each
constexpr int WGM = TWARPS / WGN; // warps along M
constexpr int MI = TBM / WGM / 16;  // m16 tiles of a warp (32 rows)
constexpr int RPT = TBM * 8 / TTHREADS;  // x rows a thread quantizes, 8 lanes a row
constexpr int TPR = TTHREADS / TBM;      // threads a row in the amax pass
constexpr int AROW = TBK + PAD;   // bytes of a row of the int8 A and B tiles
constexpr int RROW = TBN + 8;     // int32 row of the cluster's partials (padded)

constexpr int AMAX_SLOTS = 32;    // partial row amaxes a block receives

// Byte offsets of a tiled block's shared memory: the ring of raw K steps,
// two int8 (A, B) tile pairs, each group's row scales and their
// reciprocals, and the partial row amaxes of the cluster's blocks. After
// the main loop the K split's int32 partials land at offset 0
// ([split][ceil(TBM / split)][RROW]).
template <typename T> struct Tiled {
  static constexpr int XROW = TBK * (int)sizeof(T) + 16;  // raw x row, 16-byte pad
  static constexpr int X_BYTES = TBM * XROW;
  static constexpr int STAGE = X_BYTES + TBK * TBN;       // + int8 [TBK][TBN]
  static constexpr int STAGES = sizeof(T) == 2 ? 6 : 3;   // raw K steps in the ring
  static constexpr int AB = STAGES * STAGE;               // A [TBM][AROW], B [TBN][AROW]
  static constexpr int SCALE = AB + 2 * (TBM + TBN) * AROW;  // f32 [MAXC][TBM]
  static constexpr int RSCALE = SCALE + MAXC * TBM * 4;   // f32 [MAXC][TBM]
  static constexpr int AMAX = RSCALE + MAXC * TBM * 4;    // u32 [AMAX_SLOTS][TBM]
  static constexpr int BYTES = AMAX + AMAX_SLOTS * TBM * 4;
  static_assert(STAGE % 16 == 0 && XROW % 16 == 0, "16-byte copies");
  static_assert((TBM + MAXC) * RROW * 4 <= AB, "room for the cluster's partials");
  static_assert(BYTES <= 227 * 1024, "shared memory of one block");
};

// Issue the copies of one K step (K rows [k0, k0 + TBK)) into a ring slot:
// x [TBM][TBK] in its dtype (rows padded to XROW bytes) and the int8
// weights [TBK][TBN], the 16-byte chunk j of row k stored at chunk
// j ^ ((k >> 2) & 7) so that the transpose reads few banks twice. Zero past
// M and N. vec_x / vec_w: 16-byte cp.async; else plain loads and stores.
template <typename T>
__device__ __forceinline__ void tiled_load(unsigned char* slot, const T* __restrict__ x,
                                           const int8_t* __restrict__ q, int M, int K,
                                           int N, int m0, int n0, int k0, bool vec_x,
                                           bool vec_w, int tid) {
  using L = Tiled<T>;
  constexpr int EPC = 16 / sizeof(T);   // x elements a copy
  constexpr int XC = TBK / EPC;         // copies an x row
  if (vec_x) {
#pragma unroll
    for (int j = 0; j < TBM * XC / TTHREADS; ++j) {
      const int c = tid + j * TTHREADS, m = c / XC, k = (c % XC) * EPC;
      const bool in = m0 + m < M;
      cp_async16_zfill(slot + m * L::XROW + k * (int)sizeof(T),
                       x + (size_t)(in ? m0 + m : 0) * K + k0 + k, in);
    }
  } else {
    T* xs = reinterpret_cast<T*>(slot);
    for (int i = tid; i < TBM * TBK; i += TTHREADS) {
      const int m = i / TBK, k = i % TBK;
      xs[m * (L::XROW / (int)sizeof(T)) + k] =
          m0 + m < M ? x[(size_t)(m0 + m) * K + k0 + k] : from_f<T>(0.f);
    }
  }
  int8_t* ws = reinterpret_cast<int8_t*>(slot + L::X_BYTES);
  if (vec_w) {
#pragma unroll
    for (int j = 0; j < TBK * (TBN / 16) / TTHREADS; ++j) {
      const int c = tid + j * TTHREADS, k = c / (TBN / 16), ch = c % (TBN / 16);
      const bool in = n0 + ch * 16 < N;
      cp_async16_zfill(ws + k * TBN + ((ch ^ ((k >> 2) & 7)) << 4),
                       q + (size_t)(k0 + k) * N + (in ? n0 + ch * 16 : 0), in);
    }
  } else {
    for (int i = tid; i < TBK * TBN; i += TTHREADS) {
      const int k = i / TBN, n = i % TBN;
      ws[k * TBN + ((((n >> 4) ^ ((k >> 2) & 7))) << 4) + (n & 15)] =
          n0 + n < N ? q[(size_t)(k0 + k) * N + n0 + n] : (int8_t)0;
    }
  }
}

// 8 consecutive elements at p (16-byte aligned) as f32.
template <typename T> __device__ __forceinline__ void load8(const T* p, float* v) {
  load4<T>(p, v);
  load4<T>(p + 4, v + 4);
}
template <> __device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                 float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);   // bf16 -> f32 is exact
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[2 * c] = __uint_as_float(w[c] << 16);
    v[2 * c + 1] = __uint_as_float(w[c] & 0xffff0000u);
  }
}

// fast4 for the tiled design, with one flag bit per element (bit c for
// v[c]) and a margin of 1e-4 instead of 1e-3 (5x the bound of 1.9e-5).
template <bool CLIP>
__device__ __forceinline__ unsigned fast4_flags(const float* v, float rs, unsigned* packed) {
  constexpr float MAGIC = 12582912.0f;   // 1.5 * 2^23: RNE to an integer
  unsigned near = 0, b[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float y = __fmul_rn(v[c], rs);
    if (CLIP) y = fminf(fmaxf(y, -127.f), 127.f);
    const float t = __fadd_rn(y, MAGIC);
    near |= (unsigned)(fabsf(__fsub_rn(y, __fsub_rn(t, MAGIC))) > 0.4999f) << c;
    b[c] = __float_as_uint(t);           // low byte: rint(y) as an int8
  }
  *packed = __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040),
                        0x5410);
  return near;
}

// A ring slot into an (A, B) tile pair. x: thread tid quantizes, in rows
// m_i = tid / 8 + (TTHREADS / 8) i (i < RPT), the 8 elements of chunk c =
// tid % 8 (bf16: elements [8 c, 8 c + 8); f32: [4 c, 4 c + 4) and [32 + 4
// c, 36 + 4 c)), each row with its own scale sc[i] (rsc[i] = RN(1 /
// sc[i])): the fast product for all of them, then, one element at a time,
// the correctly rounded divide for each element
// flagged near a half-integer (every element of a row whose scale is NaN
// or infinite). A warp waits for its lane with the most flags, and bf16
// activations make flags common: in the dynamic mode y = 127 v / amax is
// a ratio of two 8-bit significands, an exact half-integer for whole
// classes of elements (every odd significand in the top binade of a row
// whose amax has significand 254). Eight lanes a row spread one such
// row's flags; two lanes a row left them to two threads, whose serial
// divides held up every barrier (H100). The weights are
// transposed, in 4x4 blocks of bytes, into B [TBN][AROW] (k contiguous).
template <typename T, bool CLIP>
__device__ __forceinline__ void tiled_convert(const unsigned char* slot, int8_t* a,
                                              int8_t* b, const float* sc,
                                              const float* rsc, int tid) {
  using L = Tiled<T>;
  constexpr int EPC = 16 / sizeof(T);    // elements a 16-byte load
  constexpr int NJ = 8 / EPC;            // loads a row
  {
    constexpr int RS = TTHREADS / 8;     // rows apart
    const int m0 = tid / 8, c = tid % 8;
    unsigned near = 0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const T* xr = reinterpret_cast<const T*>(slot + (m0 + RS * i) * L::XROW);
      int8_t* ar = a + (m0 + RS * i) * AROW;
      const float rs = rsc[i];   // RN(1 / sc[i])
      unsigned rnear = isfinite(sc[i]) ? 0u : 0xffu;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int e0 = (c + 8 * j) * EPC;
        float v[8];
        if constexpr (EPC == 8) {
          load8<T>(xr + e0, v);
        } else {
          load4<T>(xr + e0, v);
        }
        unsigned w[2];
#pragma unroll
        for (int h = 0; h < EPC / 4; ++h)
          rnear |= fast4_flags<CLIP>(v + 4 * h, rs, &w[h]) << (4 * (j * (EPC / 4) + h));
        if constexpr (EPC == 8) *reinterpret_cast<uint2*>(ar + e0) = make_uint2(w[0], w[1]);
        else *reinterpret_cast<unsigned*>(ar + e0) = w[0];
      }
      near |= rnear << (8 * i);
    }
    while (near) {
      const int bit = __ffs(near) - 1;
      near &= near - 1;
      const int i = bit >> 3, k = bit & 7;   // row slot, element of the slot
      const int m = m0 + RS * i, e = (c + 8 * (k / EPC)) * EPC + k % EPC;
      const T xv = reinterpret_cast<const T*>(slot + m * L::XROW)[e];
      float v;
      if constexpr (sizeof(T) == 4) v = xv;
      else v = __bfloat162float(xv);
      float s = sc[0];
#pragma unroll
      for (int u = 1; u < RPT; ++u)
        if (i == u) s = sc[u];
      a[m * AROW + e] = (int8_t)clip8(rintf(__fdiv_rn(v, s)));
    }
  }
  const int8_t* ws = reinterpret_cast<const int8_t*>(slot + L::X_BYTES);
#pragma unroll
  for (int i = 0; i < (TBK / 4) * (TBN / 4) / TTHREADS; ++i) {
    const int blk = tid + i * TTHREADS, kq = blk % (TBK / 4), nq = blk / (TBK / 4);
    const int off = (((nq >> 2) ^ (kq & 7)) << 4) + (nq & 3) * 4;
    unsigned w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = *reinterpret_cast<const unsigned*>(ws + (4 * kq + r) * TBN + off);
    // col[c] packs q[4 kq .. 4 kq + 3][4 nq + c]
    const unsigned t0 = __byte_perm(w[0], w[1], 0x5140);
    const unsigned t1 = __byte_perm(w[2], w[3], 0x5140);
    const unsigned t2 = __byte_perm(w[0], w[1], 0x7362);
    const unsigned t3 = __byte_perm(w[2], w[3], 0x7362);
    const unsigned col[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                             __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<unsigned*>(b + (4 * nq + c) * AROW + 4 * kq) = col[c];
  }
}

// One K step on the tensor cores: warp (wm, wn) adds A rows [16 MI wm,
// 16 MI (wm + 1)) times B columns [32 wn, 32 wn + 32) into acc[i][j] (the
// m16n8 tile of rows 16 (MI wm + i), columns 32 wn + 8 j).
__device__ __forceinline__ void tiled_mma(const int8_t* a, const int8_t* b,
                                          int (&acc)[MI][4][4], int wm, int wn,
                                          int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < TBK; kk += KSTEP) {
    unsigned af[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int8_t* p = a + ((wm * MI + i) * 16 + g) * AROW + kk + 4 * t4;
      af[i][0] = ld32(p);
      af[i][1] = ld32(p + 8 * AROW);
      af[i][2] = ld32(p + 16);
      af[i][3] = ld32(p + 8 * AROW + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* p = b + (wn * 32 + j * 8 + g) * AROW + kk + 4 * t4;
      const unsigned b0 = ld32(p), b1 = ld32(p + 16);
#pragma unroll
      for (int i = 0; i < MI; ++i) mma_s8(acc[i][j], af[i], b0, b1);
    }
  }
}

// The unsigned max of |x|'s f32 bit patterns over x row xr's elements
// [lo, hi) that this thread of the row's TPR takes (part < TPR).
template <typename T>
__device__ __forceinline__ unsigned row_amax(const T* __restrict__ xr, int lo, int hi,
                                             int part, bool vec) {
  unsigned a = 0;
  if (vec) {
    constexpr int EPC = 16 / sizeof(T);
#pragma unroll 4
    for (int k = lo + part * EPC; k < hi; k += TPR * EPC) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(xr + k));
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if constexpr (sizeof(T) == 4) {
          a = max(a, w[c] & 0x7fffffffu);
        } else {
          a = max(a, (w[c] << 16) & 0x7fffffffu);
          a = max(a, w[c] & 0x7fff0000u);
        }
      }
    }
  } else {
    for (int k = lo + part; k < hi; k += TPR) {
      float v;
      if constexpr (sizeof(T) == 4) v = xr[k];
      else v = __bfloat162float(xr[k]);
      a = max(a, __float_as_uint(fabsf(v)));
    }
  }
  return a;
}

__device__ __forceinline__ float scale_of(unsigned amax) {
  const float af = __uint_as_float(amax);
  const float floored = (af >= 1e-12f || af != af) ? af : 1e-12f;  // NaN stays
  return __fmul_rn(floored, INV_QMAX);
}

// The split cluster barrier of the start: arrive once the copies are
// issued, wait before the first store into another block's shared memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// NV neighbouring outputs of one row from column col: one vector store
// where all are inside N and aligned, else one store each.
template <typename T, int NV>
__device__ __forceinline__ void store_out(T* __restrict__ out, int N, int row, int col,
                                          const float* v) {
  const size_t at = (size_t)row * N + col;
  T* dst = out + at;
  if (col + NV <= N && at % NV == 0) {
    if constexpr (sizeof(T) == 4) {
      if constexpr (NV == 2) *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
      else *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      unsigned u[NV / 2];
#pragma unroll
      for (int j = 0; j < NV / 2; ++j)
        u[j] = (unsigned)__bfloat16_as_ushort(from_f<T>(v[2 * j])) |
               (unsigned)__bfloat16_as_ushort(from_f<T>(v[2 * j + 1])) << 16;
      if constexpr (NV == 2) *reinterpret_cast<unsigned*>(dst) = u[0];
      else *reinterpret_cast<uint2*>(dst) = make_uint2(u[0], u[1]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (col + j < N) dst[j] = from_f<T>(v[j]);
  }
}

// Grid: (ceil(N / TBN) * split, ceil(M / TBM)) blocks in clusters of
// split * cn along x: cn neighbouring column tiles of one M tile, each
// split `split` ways along K (cluster rank cj * split + r). split 1: a
// block walks all of K, folding its int32 accumulators into f32 ones at
// the end of each group (dynamic mode). split > 1 (a multiple of K / G):
// rank r walks K rows [r K / split, (r + 1) K / split), inside group r /
// (split / n_groups), and after the loop each block's int32 partial tile
// goes, a band of rows at a time, to the block of its column tile that
// owns the band, which adds each group's partials (int32, exact in any
// order) and runs the f32 group loop in order. The rows' amax (dynamic
// mode): each block reads 1 / cn of its K range's columns, and the
// partial maxima meet through distributed shared memory, so the cluster
// reads its rows of x once for cn column tiles.
template <typename T>
__global__ void __launch_bounds__(TTHREADS, 1)
w8a8_matmul_tiled_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                         const float* __restrict__ col_scale,
                         const float* __restrict__ act_scale, T* __restrict__ out,
                         int M, int K, int N, int G, int split, int cn, int vec_x,
                         int vec_w) {
  using L = Tiled<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = (int)cluster.block_rank(), csize = split * cn;
  const int rank = crank % split, cj = crank / split;   // K rank, column tile
  const int n0 = (blockIdx.x / split) * TBN, m0 = blockIdx.y * TBM;
  const int n_groups = K / G, per_group = split > 1 ? split / n_groups : 1;
  const int kspan = K / split, kb = rank * kspan, steps = kspan / TBK;
  float* scale_sh = reinterpret_cast<float*>(smem + L::SCALE);
  float* rscale_sh = reinterpret_cast<float*>(smem + L::RSCALE);
  unsigned* amax_sh = reinterpret_cast<unsigned*>(smem + L::AMAX);
  int8_t* tiles = reinterpret_cast<int8_t*>(smem + L::AB);   // [2][A | B]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool stat = act_scale != nullptr;

#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < steps)
      tiled_load<T>(smem + s * L::STAGE, x, q, M, K, N, m0, n0, kb + s * TBK, vec_x,
                    vec_w, tid);
    cp_async_commit();
  }
  if (csize > 1) cluster_arrive_relaxed();

  // dynamic mode: each row's amax over each group of the block's K range,
  // read from device memory (L2) while the first steps are in flight; TPR
  // threads a row, each block of the cluster's cn column tiles over 1 / cn
  // of the columns; partial maxima go to every block of the cluster, slot
  // [crank * gpb + group of the block's range] (gpb groups a block)
  if (!stat) {
    const int m = tid / TPR, part = tid % TPR;
    const bool in = m0 + m < M;
    const T* xr = x + (size_t)(in ? m0 + m : 0) * K;
    const int gpb = split == 1 ? n_groups : 1, g0 = kb / G;
    const int span = min(kspan, G) / cn;   // columns a block reads a group
    if (csize > 1) cluster_wait();
    for (int t = 0; t < gpb; ++t) {
      const int lo = max(kb, (g0 + t) * G) + cj * span;
      unsigned a = in ? row_amax<T>(xr, lo, lo + span, part, vec_x) : 0u;
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) a = max(a, __shfl_xor_sync(0xffffffffu, a, o));
      if (csize == 1) {
        if (part == 0) scale_sh[t * TBM + m] = scale_of(a);
      } else {
        for (int r = part; r < csize; r += TPR)
          *cluster.map_shared_rank(amax_sh + (crank * gpb + t) * TBM + m, r) = a;
      }
    }
    if (csize > 1) {
      cluster.sync();
      // group t's amax: the max over the blocks whose K range lies in it
      for (int i = tid; i < n_groups * TBM; i += TTHREADS) {
        const int t = i / TBM, mm = i % TBM;
        unsigned amax = 0;
        for (int c = 0; c < csize; ++c) {
          const int r = c % split;
          if (split == 1) amax = max(amax, amax_sh[(c * gpb + t) * TBM + mm]);
          else if (r / per_group == t) amax = max(amax, amax_sh[c * TBM + mm]);
        }
        scale_sh[i] = scale_of(amax);
      }
    }
    __syncthreads();
    for (int i = tid; i < n_groups * TBM; i += TTHREADS)
      rscale_sh[i] = __frcp_rn(scale_sh[i]);
  } else if (csize > 1) {
    cluster_wait();
  }
  const float s_static = stat ? __ldg(act_scale) : 0.f;
  const float rs_static = __frcp_rn(s_static);
  // step `step`'s ring slot into an (A, B) tile pair; this thread
  // quantizes x rows tid / 8 + (TTHREADS / 8) i, each with its scale
  const auto convert = [&](const unsigned char* slot, int8_t* at, int step) {
    float sc[RPT], rsc[RPT];
    if (stat) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        sc[i] = s_static;
        rsc[i] = rs_static;
      }
      tiled_convert<T, true>(slot, at, at + TBM * AROW, sc, rsc, tid);
    } else {
      const int at_g = ((kb + step * TBK) / G) * TBM + tid / 8;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        sc[i] = scale_sh[at_g + (TTHREADS / 8) * i];
        rsc[i] = rscale_sh[at_g + (TTHREADS / 8) * i];
      }
      tiled_convert<T, false>(slot, at, at + TBM * AROW, sc, rsc, tid);
    }
  };

  int acc[MI][4][4];
  float facc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        facc[i][j][e] = 0.f;
      }
  const int wm = warp / WGN, wn = warp % WGN, g = lane >> 2, t4 = lane & 3;

  cp_async_wait<L::STAGES - 2>();
  __syncthreads();   // step 0 has landed, the scales are written
  if (steps > 0) convert(smem, tiles, 0);
  for (int kt = 0; kt < steps; ++kt) {
    // step kt + 1 has landed and step kt is converted; every thread is done
    // with step kt - 1 (its tiles and its ring slot, which step kt + STAGES
    // - 1 takes)
    cp_async_wait<L::STAGES - 3>();
    __syncthreads();
    if (kt + L::STAGES - 1 < steps)
      tiled_load<T>(smem + ((kt + L::STAGES - 1) % L::STAGES) * L::STAGE, x, q, M, K, N,
                    m0, n0, kb + (kt + L::STAGES - 1) * TBK, vec_x, vec_w, tid);
    cp_async_commit();
    if (kt + 1 < steps)
      convert(smem + ((kt + 1) % L::STAGES) * L::STAGE,
              tiles + ((kt + 1) & 1) * (TBM + TBN) * AROW, kt + 1);
    const int8_t* at = tiles + (kt & 1) * (TBM + TBN) * AROW;
    tiled_mma(at, at + TBM * AROW, acc, wm, wn, lane);
    if (!stat && split == 1 && (kt + 1) * TBK % G == 0) {
      // the end of group t: acc = acc + f32(p_t) * s_t, in group order
      const float* st = scale_sh + ((kt + 1) * TBK / G - 1) * TBM + wm * 16 * MI + g;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s = st[i * 16 + 8 * h];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              int& p = acc[i][j][2 * h + e];
              facc[i][j][2 * h + e] =
                  __fadd_rn(facc[i][j][2 * h + e], __fmul_rn((float)p, s));
              p = 0;
            }
        }
    }
  }

  if (split == 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * t4;
      const float cs0 = col < N ? __ldg(col_scale + col) : 0.f;
      const float cs1 = col + 1 < N ? __ldg(col_scale + col + 1) : 0.f;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + (wm * MI + i) * 16 + g + 8 * h;
          if (row >= M || col >= N) continue;
          float v[2];
          if (stat) {
            v[0] = __fmul_rn((float)acc[i][j][2 * h], __fmul_rn(s_static, cs0));
            v[1] = __fmul_rn((float)acc[i][j][2 * h + 1], __fmul_rn(s_static, cs1));
          } else {
            v[0] = __fmul_rn(facc[i][j][2 * h], cs0);
            v[1] = __fmul_rn(facc[i][j][2 * h + 1], cs1);
          }
          store_out<T, 2>(out, N, row, col, v);
        }
    }
    return;
  }

  // split K: block r owns tile rows [r rp, (r + 1) rp); each block's int32
  // partial rows go to their owner, slot [rank][row - owner rp][col], once
  // every block of the cluster is past its loop (the ring is free)
  const int rp = (TBM + split - 1) / split;
  int* recv = reinterpret_cast<int*>(smem);
  cp_async_wait<0>();
  cluster.sync();
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = (wm * MI + i) * 16 + g + 8 * h;
      int* dst = cluster.map_shared_rank(recv, cj * split + lr / rp) +
                 (rank * rp + lr % rp) * RROW + wn * 32 + 2 * t4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<int2*>(dst + j * 8) =
            make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
  cluster.sync();
  // this block's rows: each group's partials as one int32 (static mode: all
  // of them), then the f32 group loop in order
  const int rows = min(rp, TBM - rank * rp);
  for (int e = tid; e < rows * (TBN / 4); e += TTHREADS) {
    const int lr = e / (TBN / 4), c = (e % (TBN / 4)) * 4;
    const int row = m0 + rank * rp + lr, col = n0 + c;
    if (row >= M || col >= N) continue;
    float cs[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) cs[k] = col + k < N ? __ldg(col_scale + col + k) : 0.f;
    float v[4];
    if (stat) {
      int p[4] = {0, 0, 0, 0};
      for (int r = 0; r < split; ++r) {
        const int4 u = *reinterpret_cast<const int4*>(recv + (r * rp + lr) * RROW + c);
        p[0] += u.x; p[1] += u.y; p[2] += u.z; p[3] += u.w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __fmul_rn((float)p[k], __fmul_rn(s_static, cs[k]));
    } else {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int t = 0; t < n_groups; ++t) {
        int p[4] = {0, 0, 0, 0};
        for (int r = t * per_group; r < (t + 1) * per_group; ++r) {
          const int4 u = *reinterpret_cast<const int4*>(recv + (r * rp + lr) * RROW + c);
          p[0] += u.x; p[1] += u.y; p[2] += u.z; p[3] += u.w;
        }
        const float s = scale_sh[t * TBM + rank * rp + lr];
#pragma unroll
        for (int k = 0; k < 4; ++k) a[k] = __fadd_rn(a[k], __fmul_rn((float)p[k], s));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __fmul_rn(a[k], cs[k]);
    }
    store_out<T, 4>(out, N, row, col, v);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The skinny design's split of K, or false where it does not take it.
struct Split {
  int n_groups, ks, ksp;
  bool ok;
  Split(int M, int K, int N, int G, int bn, int C) : n_groups(0), ks(0), ksp(0), ok(false) {
    if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || G > 1024 || K % G) return;
    if ((bn != 32 && bn != 64) || C < 1 || C > MAXC) return;
    n_groups = K / G;
    if (n_groups > MAXC || C % n_groups || G % (C / n_groups)) return;
    ks = G / (C / n_groups);
    if (C > 1 && ks % KSTEP) return;
    ksp = (ks + KSTEP - 1) / KSTEP * KSTEP;
    ok = true;
  }
};

// Whether the tiled design takes the call: groups of a multiple of TBK
// rows, at most MAXC of them; split 1, or a multiple of the group count
// whose blocks each take a multiple of TBK rows inside one group.
bool tiled_ok(int M, int K, int N, int G, int split) {
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || G > 1024 || K % G || G % TBK) return false;
  const int n_groups = K / G;
  if (n_groups > MAXC || split < 1 || split > MAXC) return false;
  if ((M + TBM - 1) / TBM > 65535) return false;
  if (split == 1) return true;
  return split % n_groups == 0 && G % (split / n_groups) == 0 &&
         (G / (split / n_groups)) % TBK == 0;
}

template <typename T, int BM, int BN>
int launch_kernel(const T* x, const int8_t* q, const float* cs, const float* as,
                  T* out, int M, int K, int N, int C, const Split& s, int vec_x,
                  int vec_w, cudaStream_t stream) {
  const Layout L(BM, BN, s.ksp, C, s.n_groups, sizeof(T));
  if (L.bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  static int allowed = 48 * 1024;   // per instantiation
  if (L.bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8a8_matmul_cluster_kernel<T, BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = L.bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + BN - 1) / BN) * C, (M + BM - 1) / BM);
  cfg.blockDim = dim3(threads_of<BM>());
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, w8a8_matmul_cluster_kernel<T, BM, BN>, x, q, cs, as, out, M, K, N, C,
      s.ks, s.ksp, s.n_groups, vec_x, vec_w);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The skinny design with bm rows a tile (16, 32 or 64).
template <typename T, int BN>
int launch_bm(const T* x, const int8_t* q, const float* cs, const float* as,
              T* out, int M, int K, int N, int bm, int C, const Split& s, int vx,
              int vw, cudaStream_t st) {
  if (bm == 16) return launch_kernel<T, 16, BN>(x, q, cs, as, out, M, K, N, C, s, vx, vw, st);
  if (bm == 32) return launch_kernel<T, 32, BN>(x, q, cs, as, out, M, K, N, C, s, vx, vw, st);
  if (bm == 64) return launch_kernel<T, 64, BN>(x, q, cs, as, out, M, K, N, C, s, vx, vw, st);
  return (int)cudaErrorInvalidValue;
}

// cn, the column tiles of a cluster (dynamic mode): the largest power of
// two that fits the portable cluster beside the K split, divides the
// column tiles, and leaves a block at most AMAX_SLOTS partial amaxes.
template <typename T>
int launch_tiled(const T* x, const int8_t* q, const float* cs, const float* as,
                 T* out, int M, int K, int N, int G, int split, int vx, int vw,
                 cudaStream_t stream) {
  using L = Tiled<T>;
  const int n_tiles = (N + TBN - 1) / TBN, gpb = split == 1 ? K / G : 1;
  int cn = 1;
  while (as == nullptr && split * cn * 2 <= MAXC && n_tiles % (cn * 2) == 0 &&
         split * cn * 2 * gpb <= AMAX_SLOTS)
    cn *= 2;
  static bool allowed = false;   // per instantiation
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8a8_matmul_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::BYTES);
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
  attr[0].val.clusterDim.x = split * cn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, w8a8_matmul_tiled_kernel<T>, x, q, cs,
                                           as, out, M, K, N, G, split, cn, vx, vw);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* q, const void* cs, const void* as,
           void* out, int M, int K, int N, int G, int design, int bm, int bn, int C,
           int vx, int vw, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* ct = static_cast<const float*>(cs);
  const float* at = static_cast<const float*>(as);
  T* ot = static_cast<T*>(out);
  if (design == 1) {
    if (bm != TBM || bn != TBN || !tiled_ok(M, K, N, G, C)) return (int)cudaErrorInvalidValue;
    return launch_tiled<T>(xt, qt, ct, at, ot, M, K, N, G, C, vx, vw, st);
  }
  const Split s(M, K, N, G, bn, C);
  if (design != 0 || !s.ok) return (int)cudaErrorInvalidValue;
  if (bn == 32) return launch_bm<T, 32>(xt, qt, ct, at, ot, M, K, N, bm, C, s, vx, vw, st);
  return launch_bm<T, 64>(xt, qt, ct, at, ot, M, K, N, bm, C, s, vx, vw, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out). q int8 [K, N], col_scale
// f32 [N], all row-major and contiguous; act_scale: null (dynamic mode) or
// a pointer to the static mode's f32 scale on the device; G the K-group
// width (w8a8_k_tile(K)). design 0, skinny M: bm rows of an M tile (16, 32
// or 64), bn columns of a cluster's tile (32 or 64), C blocks of a cluster
// along K (1..8, a multiple of K / G, each block's K slice a multiple of 32
// inside one group unless C = 1); launches ceil(N/bn) clusters for each M
// tile. design 1, large M: bm = bn = 128, the output tile; C = 1, or a
// multiple of K / G up to 8 whose blocks each take a multiple of 64 rows
// inside one group (G a multiple of 64); launches ceil(M/128) x
// ceil(N/128) clusters of C blocks. vec_x = 1 when K * sizeof(x) % 16 == 0
// and x is 16-byte aligned; vec_w = 1 when N % 16 == 0 and q is 16-byte
// aligned. One kernel; allocates nothing. Returns the launch's CUDA error
// code (0 on success).
int w8a8_matmul_launch(int dtype, const void* x, const void* q,
                       const void* col_scale, const void* act_scale, void* out,
                       int M, int K, int N, int G, int design, int bm, int bn, int C,
                       int vec_x, int vec_w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, q, col_scale, act_scale, out, M, K, N, G, design, bm, bn,
                         C, vec_x, vec_w, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, q, col_scale, act_scale, out, M, K, N, G, design,
                                 bm, bn, C, vec_x, vec_w, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
