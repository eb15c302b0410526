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
// What bounds it on the card: the streaming step calls it with a skinny M
// (8..112 rows for 8 streams; 568..672 for the shared x-ring's K/V
// recompute). One layer's ten matmuls read 24,117,248 weight bytes: 7.2 us
// at 3.35 TB/s. At M = 112 they are 5.4 G int8 operations, 2.7 us on the
// tensor cores at 1,979 TOPS (46 us on __dp4a). So it is bound by bytes up
// to M ~ 112, and by the per-launch floor at M <= 16, where 82% of the
// main path's calls fall.
//
// Design: one launch a call, no scratch in device memory. The grid is
// ceil(N / BN) column tiles of BN = 32 or 64 columns (64 above 16 rows,
// since every column tile quantizes its own copy of x, and wherever a wave
// of blocks stays full), each a thread-block cluster of C <= 8 blocks
// along K: C = n_groups * c, c the largest power of two that keeps each
// block's slice of KS = K / C rows a multiple of 32 inside one group
// (KS = 128 at K = 1024, 512 at K = 4096; a single group that holds no
// multiple of 32 runs with C = 1, padded with zero bytes). Along y, one
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
// What the card showed (H100): from M = 56 on, the x passes (copy from L2,
// amax, quantize), which every column tile repeats for its own columns,
// and the cluster barriers take most of the time, not the weight bytes or
// the tensor cores. A tile is a chain of waits, so one cluster a tile
// side by side (the weights re-read from L2) beat a block's loop over its
// tiles (the weights read once) where the loop ran long: the K = 4096 and
// N = 4096 calls at M = 112.
// Left for later: sharing the quantized x tile across column tiles, wgmma
// and TMA, q/k/v in one call (one read of x for three weights), and
// programmatic dependent launch against the launch floor.

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
// f32(1 / s)). |v| <= amax, so |v / s| <= 127 * (1 + 2^-22): the integer
// lies in [-127, 127] with no clip, and y lies within 2.3e-5 of the
// rounded quotient, so where y is at least 1e-3 from a half-integer both
// round to the same integer. Returns whether any of the 4 is closer than
// that: the caller then takes exact4 (as for every chunk of a row whose s
// is NaN or infinite). Rounding adds and subtracts 1.5 * 2^23, which
// leaves the integer in the low bits of the sum: no conversion instruction
// (they run at an eighth of the FMA rate).
__device__ __forceinline__ bool fast4(const float* v, float rs, unsigned* packed) {
  constexpr float MAGIC = 12582912.0f;   // 1.5 * 2^23: RNE to an integer
  bool near = false;
  unsigned b[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float y = __fmul_rn(v[c], rs);
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
// with zeros), all inside group r / (C / n_groups).
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(threads_of<BM>())
w8a8_matmul_cluster_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                           const float* __restrict__ col_scale,
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
  //    cluster
  {
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
  // 2. each group's scale per row: the max over the group's blocks
  for (int i = tid; i < n_groups * BM; i += THREADS) {
    const int t = i / BM, m = i % BM;
    unsigned a = 0;
    for (int r = t * per_group; r < (t + 1) * per_group; ++r)
      a = max(a, amax_sh[r * BM + m]);
    const float af = __uint_as_float(a);
    const float floored = (af >= 1e-12f || af != af) ? af : 1e-12f;  // NaN stays
    scale_sh[i] = __fmul_rn(floored, INV_QMAX);
  }
  __syncthreads();
  // 3. quantize this block's slice into xq [BM][row]: a loop without
  //    branches over the chunks, then the correctly rounded divide for
  //    the few chunks with a quotient near a half-integer (bit j % 64 of
  //    `near` marks chunk j)
  {
    const float sc = scale_sh[grp * BM + xm];
    const float rs = __frcp_rn(sc);
    const T* xr = xs + xm * ksp + seg * cpt * 4;
    int8_t* qr = xq + xm * row + seg * cpt * 4;
    unsigned long long near = isfinite(sc) ? 0ull : ~0ull;
    int j = j0;
#pragma unroll 4
    for (int n = 0; n < cpt; ++n) {
      float v[4];
      load4<T>(xr + j * 4, v);
      unsigned packed;
      near |= (unsigned long long)fast4(v, rs, &packed) << (j & 63);
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
  //    the f32 group loop in order
  for (int i = tid; i < BM * cw; i += THREADS) {
    const int m = i / cw, cc = i % cw, c = rank * cw + cc;
    if (c < BN && n0 + c < N && m0 + m < M) {
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

// The cluster's split of K, or false where the kernel does not take it.
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

template <typename T, int BM, int BN>
int launch_kernel(const T* x, const int8_t* q, const float* cs, T* out, int M,
                  int K, int N, int C, const Split& s, int vec_x, int vec_w,
                  cudaStream_t stream) {
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
      &cfg, w8a8_matmul_cluster_kernel<T, BM, BN>, x, q, cs, out, M, K, N, C,
      s.ks, s.ksp, s.n_groups, vec_x, vec_w);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Rows of x a tile: 16 up to M = 16, 32 up to 32, else 64 (128-row
// tiles were slower); halved while the block's shared memory would not
// let two blocks share an SM.
template <typename T, int BN>
int launch_bm(const T* x, const int8_t* q, const float* cs, T* out, int M,
              int K, int N, int C, const Split& s, int vx, int vw, cudaStream_t st) {
  int bm = M <= 16 ? 16 : M <= 32 ? 32 : 64;
  while (bm > 16 && Layout(bm, BN, s.ksp, C, s.n_groups, sizeof(T)).bytes > TWO_PER_SM)
    bm /= 2;
  if (bm == 16) return launch_kernel<T, 16, BN>(x, q, cs, out, M, K, N, C, s, vx, vw, st);
  if (bm == 32) return launch_kernel<T, 32, BN>(x, q, cs, out, M, K, N, C, s, vx, vw, st);
  return launch_kernel<T, 64, BN>(x, q, cs, out, M, K, N, C, s, vx, vw, st);
}

template <typename T>
int launch(const void* x, const void* q, const void* cs, void* out, int M,
           int K, int N, int bn, int C, const Split& s, int vx, int vw,
           cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* ct = static_cast<const float*>(cs);
  T* ot = static_cast<T*>(out);
  if (bn == 32) return launch_bm<T, 32>(xt, qt, ct, ot, M, K, N, C, s, vx, vw, st);
  return launch_bm<T, 64>(xt, qt, ct, ot, M, K, N, C, s, vx, vw, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out). q int8 [K, N], col_scale
// f32 [N], all row-major and contiguous; G the K-group width
// (w8a8_k_tile(K)); bn: columns of a cluster's tile (32 or 64); C: blocks
// of a cluster along K (1..8, a multiple of K / G, each block's K slice a
// multiple of 32 inside one group unless C = 1). vec_x = 1 when
// K * sizeof(x) % 16 == 0 and x is 16-byte aligned; vec_w = 1 when
// N % 16 == 0 and q is 16-byte aligned. Launches one kernel: ceil(N/bn)
// clusters of C blocks for each M tile. Allocates nothing. Returns the
// launch's CUDA error code (0 on success).
int w8a8_matmul_launch(int dtype, const void* x, const void* q,
                       const void* col_scale, void* out, int M, int K, int N,
                       int G, int bn, int C, int vec_x, int vec_w, void* stream) {
  const Split s(M, K, N, G, bn, C);
  if (!s.ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, q, col_scale, out, M, K, N, bn, C, s, vec_x, vec_w, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, q, col_scale, out, M, K, N, bn, C, s, vec_x,
                                 vec_w, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
