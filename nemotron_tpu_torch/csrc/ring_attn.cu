// Fused ring-buffer attention of the streaming encoder, for Hopper (sm_90a).
//
// Per (stream b, head h), with the layer l chosen inside the kernel from
// the stacked rings [L, B, H, KV, Dh]:
//
//   s   = [ (q_u . K_ring[l]^T) * k_cols  |  q_u . K_new^T ] / sqrt(Dh) + a
//   w   = softmax(s)                                       (f32, per row)
//   ctx = round(w[:, :KV] * v_cols) . V_ring[l] + round(w[:, KV:]) . V_new
//
// Replaces the Pallas TPU kernel `fused_ring_attention`
// (nemotron_tpu/ops/ring_attn_kernel.py:87, body `_kernel` :38-82) and keeps
// its arithmetic: f32 dots over compute-dtype operands on the CUDA cores
// (int8 ring values are exact in either compute dtype), f32 softmax, the
// value-side weights rounded to the compute dtype before the context dot,
// the context stored in the compute dtype. a = pos_bias / sqrt(Dh) + mask is
// built by the caller.
//
// Ring types: the compute dtype, int8, or int4 packed two a byte (the JAX
// package's bitcast of int4[..., Dh/2, 2] to int8: element 2i in the low
// nibble, 2i+1 in the high one, each signed). Packed rows are read as they
// are -- Dh/2 bytes a row, 8-byte cp.async copies where a row is not a
// whole number of 16 bytes (Dh = 16) -- and sign-extended to f32 in the
// shared-memory loads, so an int4 call moves half the ring bytes of an int8
// one; no pass unpacks the ring to bytes first. Nibble values are exact in
// either compute dtype, and the scale columns apply as for int8.
//
// What bounds it on the card: at full width (B = 1, H = 8, Dh = 128,
// KV = 84, Q = 14, f32) one launch moves about 0.96 MB and does about
// 4 MFLOP: 0.29 us at 3.35 TB/s. Neither bytes nor FLOPs bound it; latency
// does: the launch, the round trip to device memory and the barriers
// between its dependent phases (scores -> row max -> row sum -> context).
// With B = 1 there are only 8 (stream, head) pairs for 132 SMs, so the
// work of a pair has to be spread over several SMs, and no device-memory
// read may sit inside a dependent loop.
//
// Design: a thread-block cluster of C <= 8 blocks per (stream, head); block
// r of the cluster takes the contiguous key slice [r*S/C, (r+1)*S/C) of the
// S = KV + Q keys (ring slots first, then the new keys), so B = 1 runs
// 8 * C blocks. Each block issues every load it needs at once: its ring
// K/V rows (one contiguous run of the (l, b, h) ring slice each), its new
// K/V rows and q_u as 16-byte cp.async copies into padded shared-memory
// rows, the bias and the dequant columns as plain loads beside them. Then:
//   1. scores of the slice: from Q = 3 on a thread takes one key and two
//      query rows, so each key row is read from shared memory once for two
//      dots (below, one dot a thread);
//   2. each block's row maxima are pushed into every block's shared memory
//      (distributed shared memory), a cluster barrier, and every block takes
//      the max over the cluster's ranks; the same for the row sums of
//      exp(s - m), added in rank order, so every block holds the same m and
//      sum;
//   3. w = e / sum and the value-side weights, rounded to the compute dtype;
//   4. the partial context of the slice from the staged value rows, a
//      thread taking 4 columns of two query rows from Q = 3 on (one 16-byte
//      read of a value row for 8 FMAs; below, one column of one row);
//   5. the partial contexts go to the block that owns
//      their Dh / C output columns, a cluster barrier, and each block adds
//      its columns' partials in rank order and stores them in the compute
//      dtype.
// Three cluster barriers (plus one split barrier at the start that the
// loads hide). No workspace in device memory and no atomics: the result is
// deterministic.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAXQ = 16;      // query rows a cluster takes
constexpr int MAXC = 8;       // the portable cluster size
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t v) { return (float)v; }

// The packed int4 ring type: a tag, never dereferenced.
struct nib4 {};

// Bytes of n consecutive elements of a row (n even for nib4).
template <typename R> __host__ __device__ constexpr int row_bytes(int n) {
  return n * (int)sizeof(R);
}
template <> __host__ __device__ constexpr int row_bytes<nib4>(int n) { return n / 2; }

// The signed nibble at bits [s, s + 4) of w, as f32.
__device__ __forceinline__ float nibble(unsigned w, int s) {
  return (float)((int)(w << (28 - s)) >> 28);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The split cluster barrier of the start: every block arrives once its
// loads are issued and waits just before its first store into another
// block's shared memory, which must not come before that block has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// 16 consecutive elements at p (16-byte aligned; 8 for nib4) as f32.
template <typename T> __device__ __forceinline__ void load16(const unsigned char* p, float* v);
template <> __device__ __forceinline__ void load16<float>(const unsigned char* p, float* v) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 f = reinterpret_cast<const float4*>(p)[c];
    v[4 * c] = f.x; v[4 * c + 1] = f.y; v[4 * c + 2] = f.z; v[4 * c + 3] = f.w;
  }
}
template <> __device__ __forceinline__ void load16<__nv_bfloat16>(const unsigned char* p, float* v) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[c];
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {   // bf16 -> f32 is exact: the high half
      v[8 * c + 2 * e] = __uint_as_float(w[e] << 16);
      v[8 * c + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}
template <> __device__ __forceinline__ void load16<int8_t>(const unsigned char* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    v[e] = (float)(int8_t)((w[e >> 2] >> (8 * (e & 3))) & 0xffu);
}
template <> __device__ __forceinline__ void load16<nib4>(const unsigned char* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    v[e] = nibble(u.x, 4 * e);
    v[8 + e] = nibble(u.y, 4 * e);
  }
}

// 4 consecutive elements at p (aligned to 4 elements) as f32.
template <typename T> __device__ __forceinline__ void load4(const unsigned char* p, float* v);
template <> __device__ __forceinline__ void load4<float>(const unsigned char* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
template <> __device__ __forceinline__ void load4<__nv_bfloat16>(const unsigned char* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}
template <> __device__ __forceinline__ void load4<int8_t>(const unsigned char* p, float* v) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = (float)(int8_t)((u >> (8 * e)) & 0xffu);
}
template <> __device__ __forceinline__ void load4<nib4>(const unsigned char* p, float* v) {
  const unsigned u = *reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = nibble(u, 4 * e);
}

// Element d of a row as f32.
template <typename T> __device__ __forceinline__ float load1(const unsigned char* row, int d) {
  return to_f<T>(reinterpret_cast<const T*>(row)[d]);
}
template <> __device__ __forceinline__ float load1<nib4>(const unsigned char* row, int d) {
  return nibble(row[d >> 1], 4 * (d & 1));
}

// f32 dot of a compute-dtype row a and a key row b (type K) of Dh
// elements, both staged in shared memory; four interleaved accumulators.
template <typename T, typename K>
__device__ __forceinline__ float dot_row(const unsigned char* a,
                                         const unsigned char* b, int Dh) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d = 0; d < Dh; d += 16) {
    float x[16], y[16];
    load16<K>(b + row_bytes<K>(d), y);
    load16<T>(a + row_bytes<T>(d), x);
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e & 3] = fmaf(x[e], y[e], acc[e & 3]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// The same for two compute-dtype rows a0, a1 and one key row b (type K) of
// Dh elements, all staged in shared memory: the key row is read once for
// both. Four interleaved accumulators a row.
template <typename T, typename K>
__device__ __forceinline__ void dot_rows2(const unsigned char* a0,
                                          const unsigned char* a1,
                                          const unsigned char* b, int Dh,
                                          float* c) {
  float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d = 0; d < Dh; d += 16) {
    float x0[16], x1[16], y[16];
    load16<K>(b + row_bytes<K>(d), y);
    load16<T>(a0 + row_bytes<T>(d), x0);
    load16<T>(a1 + row_bytes<T>(d), x1);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      acc0[e & 3] = fmaf(x0[e], y[e], acc0[e & 3]);
      acc1[e & 3] = fmaf(x1[e], y[e], acc1[e & 3]);
    }
  }
  c[0] = (acc0[0] + acc0[1]) + (acc0[2] + acc0[3]);
  c[1] = (acc1[0] + acc1[1]) + (acc1[2] + acc1[3]);
}

// Byte offsets of one block's shared memory. Rows are padded by 16 bytes,
// so that threads reading 16 bytes each from different rows hit different
// banks; every array starts on 16 bytes.
struct Layout {
  int rowR, rowT;                           // padded row bytes (ring, compute)
  int kr, vr, kn, vn, qs;                   // byte offsets of the row arrays
  int sc, as, kc, vc, mrem, srem, recv;     // byte offsets of f32 arrays
  int bytes;
  __host__ __device__ Layout(int Q, int KV, int Dh, int C, int ringRow, int szT) {
    const int S = KV + Q, nj = (S + C - 1) / C, nn = nj < Q ? nj : Q;
    rowR = ringRow + 16;
    rowT = Dh * szT + 16;
    int o = 0;
    kr = o; o += up16(nj * rowR);
    vr = o; o += up16(nj * rowR);
    kn = o; o += nn * rowT;
    vn = o; o += nn * rowT;
    qs = o; o += Q * rowT;
    sc = o; o += f32_bytes(Q * nj);
    as = o; o += f32_bytes(Q * nj);
    kc = o; o += f32_bytes(nj);
    vc = o; o += f32_bytes(nj);
    mrem = o; o += f32_bytes(C * Q);
    srem = o; o += f32_bytes(C * Q);
    recv = o; o += f32_bytes(C * Q * (Dh / C));
    bytes = o;
  }
  // n floats, rounded up to whole 16-byte chunks
  __host__ __device__ static int f32_bytes(int n) { return ((n + 3) / 4) * 16; }
  __host__ __device__ static int up16(int n) { return (n + 15) / 16 * 16; }
};

// T: compute dtype (float or bf16). R: ring type (T, int8 or nib4).
// Grid: BH * C blocks in clusters of C. Requires Q <= MAXQ, Dh % 16 == 0,
// Dh % (4 * C) == 0 and 16-byte aligned q_u, k_new, v_new and rings.
template <typename T, typename R>
__global__ void __launch_bounds__(THREADS)
ring_attn_cluster_kernel(const T* __restrict__ q_u, const T* __restrict__ k_new,
                         const T* __restrict__ v_new,
                         const unsigned char* __restrict__ k_ring,
                         const unsigned char* __restrict__ v_ring,
                         const T* __restrict__ a,
                         const float* __restrict__ k_cols,
                         const float* __restrict__ v_cols, T* __restrict__ out,
                         int layer, int BH, int Q, int KV, int Dh, int C,
                         float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int RB = row_bytes<R>(Dh);                  // bytes of a ring row
  const Layout L(Q, KV, Dh, C, RB, sizeof(T));
  const int S = KV + Q;
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / C;
  const int j0 = rank * S / C, j1 = (rank + 1) * S / C, nj = j1 - j0;
  const int nr = max(0, min(j1, KV) - j0);          // ring keys of the slice
  const int nn = nj - nr;                           // new keys of the slice
  const int jn0 = j0 + nr - KV;                     // first new key's index
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t qoff = (size_t)bh * Q * Dh;                  // q/k/v_new/out
  const size_t roff = ((size_t)layer * BH + bh) * KV;   // this layer's ring rows
  const size_t coff = (size_t)bh * KV;                      // k/v_cols
  const size_t aoff = (size_t)bh * Q * S;

  unsigned char* kr = smem + L.kr;
  unsigned char* vr = smem + L.vr;
  unsigned char* kn = smem + L.kn;
  unsigned char* vn = smem + L.vn;
  unsigned char* qs = smem + L.qs;
  float* sc = reinterpret_cast<float*>(smem + L.sc);    // [Q][nj]
  float* as = reinterpret_cast<float*>(smem + L.as);    // [Q][nj]
  float* kc = reinterpret_cast<float*>(smem + L.kc);
  float* vc = reinterpret_cast<float*>(smem + L.vc);
  float* mrem = reinterpret_cast<float*>(smem + L.mrem);  // [C][Q]
  float* srem = reinterpret_cast<float*>(smem + L.srem);  // [C][Q]
  const int DC = Dh / C;
  float* recv = reinterpret_cast<float*>(smem + L.recv);  // [C][Q][DC]

  // every load of the block, issued at once
  {
    // ring rows in 16-byte copies, or 8-byte ones where a row is not a
    // whole number of 16 bytes (packed int4 at Dh = 16)
    const int CB = RB % 16 ? 8 : 16, cr = RB / CB, ct = Dh * (int)sizeof(T) / 16;
    const unsigned char* kg = k_ring + (roff + j0) * RB;
    const unsigned char* vg = v_ring + (roff + j0) * RB;
    if (CB == 16) {
      for (int c = tid; c < nr * cr; c += THREADS) {
        const int row = c / cr, col = (c % cr) * 16;
        cp_async16(kr + row * L.rowR + col, kg + (size_t)c * 16);
        cp_async16(vr + row * L.rowR + col, vg + (size_t)c * 16);
      }
    } else {
      for (int c = tid; c < nr * cr; c += THREADS) {
        const int row = c / cr, col = (c % cr) * 8;
        cp_async8(kr + row * L.rowR + col, kg + (size_t)c * 8);
        cp_async8(vr + row * L.rowR + col, vg + (size_t)c * 8);
      }
    }
    const unsigned char* kng = reinterpret_cast<const unsigned char*>(
        k_new + qoff + (size_t)max(jn0, 0) * Dh);
    const unsigned char* vng = reinterpret_cast<const unsigned char*>(
        v_new + qoff + (size_t)max(jn0, 0) * Dh);
    for (int c = tid; c < nn * ct; c += THREADS) {
      const int row = c / ct, col = (c % ct) * 16;
      cp_async16(kn + row * L.rowT + col, kng + (size_t)c * 16);
      cp_async16(vn + row * L.rowT + col, vng + (size_t)c * 16);
    }
    const unsigned char* qg = reinterpret_cast<const unsigned char*>(q_u + qoff);
    for (int c = tid; c < Q * ct; c += THREADS)
      cp_async16(qs + (c / ct) * L.rowT + (c % ct) * 16, qg + (size_t)c * 16);
    for (int p = tid; p < Q * nj; p += THREADS)
      as[p] = to_f<T>(a[aoff + (size_t)(p / nj) * S + j0 + p % nj]);
    for (int j = tid; j < nr; j += THREADS) {
      kc[j] = k_cols[coff + j0 + j];
      vc[j] = v_cols[coff + j0 + j];
    }
  }
  cluster_arrive_relaxed();
  cp_async_wait_all();
  __syncthreads();

  // 1. scores of the slice. From Q = 3 on, a thread takes one key jj and
  //    two query rows; below, one (row, key) dot a thread keeps more
  //    threads busy. Either way each dot sums in the same order.
  const bool pairs = Q > 2;
  const int IP = pairs ? (Q + 1) / 2 : Q;            // query rows (pairs)
  for (int p = tid; p < nj * IP; p += THREADS) {
    const int jj = p % nj, i0 = pairs ? (p / nj) * 2 : p / nj;
    const int i1 = pairs && i0 + 1 < Q ? i0 + 1 : i0;
    const bool ring = jj < nr;
    const unsigned char* kj = ring ? kr + jj * L.rowR : kn + (jj - nr) * L.rowT;
    float c[2];
    if (pairs) {
      if (ring) dot_rows2<T, R>(qs + i0 * L.rowT, qs + i1 * L.rowT, kj, Dh, c);
      else dot_rows2<T, T>(qs + i0 * L.rowT, qs + i1 * L.rowT, kj, Dh, c);
    } else {
      c[0] = c[1] = ring ? dot_row<T, R>(qs + i0 * L.rowT, kj, Dh)
                         : dot_row<T, T>(qs + i0 * L.rowT, kj, Dh);
    }
    if (ring) {
      c[0] = __fmul_rn(c[0], kc[jj]);
      c[1] = __fmul_rn(c[1], kc[jj]);
    }
    sc[i0 * nj + jj] = __fadd_rn(__fmul_rn(c[0], scale), as[i0 * nj + jj]);
    sc[i1 * nj + jj] = __fadd_rn(__fmul_rn(c[1], scale), as[i1 * nj + jj]);
  }
  __syncthreads();
  cluster_wait();   // every block of the cluster runs: DSMEM is usable

  // 2. row max over the cluster: push this slice's max to every block
  for (int i = warp; i < Q; i += NWARPS) {
    float m = -INFINITY;
    for (int j = lane; j < nj; j += 32) m = fmaxf(m, sc[i * nj + j]);
    m = warp_max(m);
    if (lane < C) *cluster.map_shared_rank(mrem + rank * Q + i, lane) = m;
  }
  cluster.sync();
  //    row sum of exp(s - m) over the cluster, added in rank order
  for (int i = warp; i < Q; i += NWARPS) {
    float m = -INFINITY;
    for (int r = 0; r < C; ++r) m = fmaxf(m, mrem[r * Q + i]);
    float sum = 0.f;
    for (int j = lane; j < nj; j += 32) {
      const float e = expf(sc[i * nj + j] - m);
      sc[i * nj + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane < C) *cluster.map_shared_rank(srem + rank * Q + i, lane) = sum;
  }
  cluster.sync();
  // 3. weights, and the compute-dtype value-side weights
  for (int i = warp; i < Q; i += NWARPS) {
    float sum = 0.f;
    for (int r = 0; r < C; ++r) sum += srem[r * Q + i];
    for (int j = lane; j < nj; j += 32) {
      const float w = sc[i * nj + j] / sum;
      sc[i * nj + j] = j < nr ? round_to<T>(__fmul_rn(w, vc[j])) : round_to<T>(w);
    }
  }
  __syncthreads();

  // 4. partial context of the slice, pushed to the block that owns the
  //    columns. From Q = 3 on, a thread takes 4 columns d..d+3 of two query
  //    rows (one 16-byte read of a value row for 8 FMAs, one 16-byte store
  //    a row); below, one column of one row a thread. Each output sums over
  //    the keys in the same order either way.
  if (pairs) {
    const int CQ = Dh / 4;
    for (int t = tid; t < CQ * IP; t += THREADS) {
      const int d = (t % CQ) * 4, i0 = (t / CQ) * 2;
      const bool two = i0 + 1 < Q;
      const float* w0 = sc + i0 * nj;
      const float* w1 = two ? w0 + nj : w0;
      float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
      for (int jj = 0; jj < nj; ++jj) {
        float v[4];
        if (jj < nr) load4<R>(vr + jj * L.rowR + row_bytes<R>(d), v);
        else load4<T>(vn + (jj - nr) * L.rowT + row_bytes<T>(d), v);
        const float x0 = w0[jj], x1 = w1[jj];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a0[e] = fmaf(x0, v[e], a0[e]);
          a1[e] = fmaf(x1, v[e], a1[e]);
        }
      }
      float* dst = recv + (rank * Q + i0) * DC + d % DC;
      *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, d / DC)) =
          make_float4(a0[0], a0[1], a0[2], a0[3]);
      if (two)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(dst + DC, d / DC)) =
            make_float4(a1[0], a1[1], a1[2], a1[3]);
    }
  } else {
    for (int idx = tid; idx < Q * Dh; idx += THREADS) {
      const int i = idx / Dh, d = idx % Dh;
      const float* wr = sc + i * nj;
      float acc = 0.f;
      for (int jj = 0; jj < nr; ++jj)
        acc = fmaf(wr[jj], load1<R>(vr + jj * L.rowR, d), acc);
      for (int jj = nr; jj < nj; ++jj)
        acc = fmaf(wr[jj], load1<T>(vn + (jj - nr) * L.rowT, d), acc);
      *cluster.map_shared_rank(recv + (rank * Q + i) * DC + d % DC, d / DC) = acc;
    }
  }
  cluster.sync();

  // 5. this block's Dh / C output columns: the partials in rank order
  for (int idx = tid; idx < Q * DC; idx += THREADS) {
    const int i = idx / DC, dd = idx % DC;
    float s = 0.f;
    for (int r = 0; r < C; ++r) s += recv[(r * Q + i) * DC + dd];
    out[qoff + (size_t)i * Dh + rank * DC + dd] = from_f<T>(s);
  }
}

template <typename T, typename R>
int launch(const void* q_u, const void* k_new, const void* v_new,
           const void* k_ring, const void* v_ring, const void* a,
           const void* k_cols, const void* v_cols, void* out, int layer,
           int BH, int Q, int KV, int Dh, int C, float scale,
           cudaStream_t stream) {
  const Layout L(Q, KV, Dh, C, row_bytes<R>(Dh), sizeof(T));
  if (L.bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  static int allowed = 48 * 1024;   // per instantiation
  if (L.bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        ring_attn_cluster_kernel<T, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = L.bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH * C);
  cfg.blockDim = dim3(THREADS);
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
      &cfg, ring_attn_cluster_kernel<T, R>, static_cast<const T*>(q_u),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<const unsigned char*>(k_ring),
      static_cast<const unsigned char*>(v_ring),
      static_cast<const T*>(a), static_cast<const float*>(k_cols),
      static_cast<const float*>(v_cols), static_cast<T*>(out), layer, BH, Q,
      KV, Dh, C, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ring_attn_max_q() { return MAXQ; }

// dtype: 0 = float32, 1 = bfloat16 (q_u, k_new, v_new, a, out).
// ring_type: 0 = rings in the compute dtype, 1 = int8 rings, 2 = int4 rings
// packed two a byte ([L,B,H,KV,Dh/2] bytes, element 2i in the low nibble).
// Layouts (row-major, contiguous): q_u/k_new/v_new/out [B,H,Q,Dh];
// rings [L,B,H,KV,Dh] (Dh/2 bytes a row when packed); a [B,H,Q,KV+Q];
// k_cols/v_cols f32 [B,H,KV]. BH = B*H; Q <= 16; Dh a multiple of 16 and of
// 4 * the cluster size C (1..8); q_u, k_new, v_new and the rings 16-byte
// aligned. Launches BH clusters of C blocks. Returns the launch's CUDA
// error code (0 on success).
int ring_attn_launch(int dtype, int ring_type, const void* q_u,
                     const void* k_new, const void* v_new, const void* k_ring,
                     const void* v_ring, const void* a, const void* k_cols,
                     const void* v_cols, void* out, int layer, int BH, int Q,
                     int KV, int Dh, int C, float scale, void* stream) {
  if (Q <= 0 || Q > MAXQ || KV <= 0 || BH <= 0 || Dh <= 0 || Dh % 16 ||
      C < 1 || C > MAXC || Dh % (4 * C) || layer < 0 || ring_type < 0 ||
      ring_type > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RING_LAUNCH(T, R)                                                      \
  launch<T, R>(q_u, k_new, v_new, k_ring, v_ring, a, k_cols, v_cols, out,     \
               layer, BH, Q, KV, Dh, C, scale, s)
  if (dtype == 0) {
    if (ring_type == 0) return RING_LAUNCH(float, float);
    if (ring_type == 1) return RING_LAUNCH(float, int8_t);
    return RING_LAUNCH(float, nib4);
  }
  if (dtype == 1) {
    if (ring_type == 0) return RING_LAUNCH(__nv_bfloat16, __nv_bfloat16);
    if (ring_type == 1) return RING_LAUNCH(__nv_bfloat16, int8_t);
    return RING_LAUNCH(__nv_bfloat16, nib4);
  }
#undef RING_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
