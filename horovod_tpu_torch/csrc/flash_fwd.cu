// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel horovod_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd through pl.pallas_call). It computes the same thing:
// for each (batch*head, query row), an online softmax over key/value
// tiles with f32 scores, the finite -1e30 masks for keys past the
// sequence end and (causal) keys after the query, the running max m and
// normaliser l, out = acc / safe_l and lse = m + log(safe_l), where
// safe_l = l > 0 ? l : 1. GQA reads k/v of head bh / q_per_kv, so grouped
// k/v are never copied per query head.
//
// Translation. The TPU grid ran its kv dimension in order on one core,
// carrying acc/m/l in VMEM scratch across grid steps. Hopper blocks run
// in no order, so the kv dimension becomes a loop inside one thread
// block: the block owns (bh, query tile), keeps acc/m/l in registers and
// stages one K/V tile at a time in shared memory. The causal block skip
// ends that loop at the tile holding the block's last diagonal key, and
// the ragged end of the sequence is masked in the kernel instead of
// padding T in device memory.
//
// What bounds it. At the training shape (bf16, B=4, T=2048, H=32,
// Hkv=8, D=128, causal) the work is ~1.4e11 FLOP against ~168 MB of
// q/k/v/out: ~820 FLOP per byte, far above the H100's ~295 FLOP/byte
// ridge, so it is bound by tensor-core operations (bound ~0.14 ms at
// 989 TFLOP/s dense bf16). The bf16 path therefore runs both products on
// the tensor cores (mma.sync m16n8k16, f32 accumulation): Q.K^T is exact
// up to summation order, and P is rounded to bf16 for P.V (the TPU
// kernel's P.V is f32) — the cost is stated with the tolerance in the
// tests and chip_smoke.py. This first version loads K/V synchronously
// with plain 16-byte loads; TMA, wgmma and warp specialisation are the
// next steps. f32 inputs take a plain f32 (SIMT) kernel with f32 P.V,
// which matches the TPU kernel's arithmetic to summation order.
//
// C interface: hvd_flash_fwd(...) returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's finite NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_one(float* p, float a) { *p = a; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores through mma.sync.m16n8k16 (f32 accumulate).
//
// Fragment layout (PTX ISA, m16n8k16 with 16-bit A/B): with g = lane / 4
// and c = lane % 4,
//   A (16x16, row major) regs: {(g, 2c..2c+1), (g+8, 2c..), (g, 2c+8..),
//                               (g+8, 2c+8..)}
//   B (16x8, k x n)      regs: {(k=2c..2c+1, n=g), (k=2c+8..2c+9, n=g)}
//   C (16x8 f32)         vals: {(g, 2c), (g, 2c+1), (g+8, 2c), (g+8, 2c+1)}
// The C fragments of S for two adjacent 8-key tiles are exactly the A
// fragment of P for one 16-key step of P.V, so P never leaves registers.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows per block
constexpr int kMmaKeys = 64;              // keys per K/V tile
constexpr int kMmaThreads = 32 * kMmaWarps;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bits(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <int D, typename TOut>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  TOut* __restrict__ out, float* __restrict__ lse, int t,
                  int q_per_kv, float scale, int causal) {
  // Rows padded by 8 elements (16 bytes): the fragment reads below then
  // touch 32 distinct banks per warp.
  constexpr int kStride = D + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaKeys * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kMmaKeys * kStride];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * t * D;
  const size_t kv_off = static_cast<size_t>(bh / q_per_kv) * t * D;
  const __nv_bfloat16* kb = k + kv_off;
  const __nv_bfloat16* vb = v + kv_off;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int r1 = r0 + 8;

  // Q stays in registers (A fragments) for the whole kv loop; rows past
  // the sequence end read as zero and are never stored.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = kk * 16 + 2 * c;
    qf[kk][0] = r0 < t ? *reinterpret_cast<const uint32_t*>(
                             qb + static_cast<size_t>(r0) * D + col)
                       : 0u;
    qf[kk][1] = r1 < t ? *reinterpret_cast<const uint32_t*>(
                             qb + static_cast<size_t>(r1) * D + col)
                       : 0u;
    qf[kk][2] = r0 < t ? *reinterpret_cast<const uint32_t*>(
                             qb + static_cast<size_t>(r0) * D + col + 8)
                       : 0u;
    qf[kk][3] = r1 < t ? *reinterpret_cast<const uint32_t*>(
                             qb + static_cast<size_t>(r1) * D + col + 8)
                       : 0u;
  }

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the sums

  const int n_tiles = (t + kMmaKeys - 1) / kMmaKeys;
  const int last_row = min(q0 + kMmaRows, t) - 1;
  const int kt_end = causal ? min(n_tiles, last_row / kMmaKeys + 1)
                            : n_tiles;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kMmaKeys;
    __syncthreads();  // every warp is done with the previous tile
    constexpr int kChunksPerRow = D / 8;  // 16-byte chunks
    for (int i = threadIdx.x; i < kMmaKeys * kChunksPerRow;
         i += kMmaThreads) {
      const int row = i / kChunksPerRow;
      const int col = (i % kChunksPerRow) * 8;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (k0 + row < t) {
        const size_t off = static_cast<size_t>(k0 + row) * D + col;
        kx = *reinterpret_cast<const uint4*>(kb + off);
        vx = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(ks + row * kStride + col) = kx;
      *reinterpret_cast<uint4*>(vs + row * kStride + col) = vx;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 tiles of 8 keys).
    float s[kMmaKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kMmaKeys / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kp = ks + (j * 8 + g) * kStride + 2 * c;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kp + kk * 16 + 8);
        mma_16816(s[j], qf[kk], b0, b1);
      }
    }

    // Scale, mask, and the tile's row max (each row spans a lane quad).
    float tmax0 = kNegInf, tmax1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kMmaKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + 2 * c + e;
        float a = s[j][e] * scale;
        float b = s[j][2 + e] * scale;
        if (key >= t || (causal && key > r0)) a = kNegInf;
        if (key >= t || (causal && key > r1)) b = kNegInf;
        s[j][e] = a;
        s[j][2 + e] = b;
        tmax0 = fmaxf(tmax0, a);
        tmax1 = fmaxf(tmax1, b);
      }
    }
    tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, 1));
    tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, 2));
    tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, 1));
    tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, 2));
    const float mn0 = fmaxf(m0, tmax0);
    const float mn1 = fmaxf(m1, tmax1);
    const float alpha0 = exp2f((m0 - mn0) * kLog2e);
    const float alpha1 = exp2f((m1 - mn1) * kLog2e);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kMmaKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f((s[j][e] - mn0) * kLog2e);
        s[j][2 + e] = exp2f((s[j][2 + e] - mn1) * kLog2e);
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= alpha0;
      o[dn][1] *= alpha0;
      o[dn][2] *= alpha1;
      o[dn][3] *= alpha1;
    }

    // O += P V, 16 keys per step; P rounded to bf16 here.
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t a[4] = {pack_rn(s[2 * kk][0], s[2 * kk][1]),
                             pack_rn(s[2 * kk][2], s[2 * kk][3]),
                             pack_rn(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_rn(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vp = vs + (kk * 16 + 2 * c) * kStride + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* p = vp + dn * 8;
        const uint32_t b0 = pack_bits(p[0], p[kStride]);
        const uint32_t b1 = pack_bits(p[8 * kStride], p[9 * kStride]);
        mma_16816(o[dn], a, b0, b1);
      }
    }
  }

  // The row sums were kept per thread; a row's total is its quad's sum.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float safe0 = l0 > 0.f ? l0 : 1.f;
  const float safe1 = l1 > 0.f ? l1 : 1.f;
  TOut* ob = out + static_cast<size_t>(bh) * t * D;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * c;
    if (r0 < t)
      store_pair(ob + static_cast<size_t>(r0) * D + col, o[dn][0] / safe0,
                 o[dn][1] / safe0);
    if (r1 < t)
      store_pair(ob + static_cast<size_t>(r1) * D + col, o[dn][2] / safe1,
                 o[dn][3] / safe1);
  }
  if (c == 0) {
    if (r0 < t) lse[static_cast<size_t>(bh) * t + r0] = m0 + logf(safe0);
    if (r1 < t) lse[static_cast<size_t>(bh) * t + r1] = m1 + logf(safe1);
  }
}

// ---------------------------------------------------------------------------
// f32 inputs: plain f32 arithmetic. A warp walks kSimtRowsPerWarp query
// rows; for each 32-key tile, lane j scores key j, the warp reduces the
// row max and sum by shuffles, and lane i accumulates output columns
// i, i + 32, ... of P.V in f32.
// ---------------------------------------------------------------------------

constexpr int kSimtWarps = 4;
constexpr int kSimtRowsPerWarp = 4;
constexpr int kSimtRows = kSimtWarps * kSimtRowsPerWarp;
constexpr int kSimtKeys = 32;
constexpr int kSimtThreads = 32 * kSimtWarps;

template <int D, typename TIn, typename TOut>
__global__ void __launch_bounds__(kSimtThreads)
    flash_fwd_simt(const TIn* __restrict__ q, const TIn* __restrict__ k,
                   const TIn* __restrict__ v, TOut* __restrict__ out,
                   float* __restrict__ lse, int t, int q_per_kv, float scale,
                   int causal) {
  __shared__ float qs[kSimtRows][D];
  __shared__ float ks[kSimtKeys][D + 1];  // +1: lane j reads row j
  __shared__ float vs[kSimtKeys][D];
  constexpr int kCols = D / 32;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kSimtRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const TIn* qb = q + static_cast<size_t>(bh) * t * D;
  const size_t kv_off = static_cast<size_t>(bh / q_per_kv) * t * D;

  for (int i = threadIdx.x; i < kSimtRows * D; i += kSimtThreads) {
    const int row = i / D, col = i % D;
    qs[row][col] = q0 + row < t
                       ? to_f32(qb[static_cast<size_t>(q0 + row) * D + col])
                       : 0.f;
  }

  float acc[kSimtRowsPerWarp][kCols];
  float m[kSimtRowsPerWarp], l[kSimtRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc[rr][cc] = 0.f;
  }

  const int n_tiles = (t + kSimtKeys - 1) / kSimtKeys;
  const int last_row = min(q0 + kSimtRows, t) - 1;
  const int kt_end = causal ? min(n_tiles, last_row / kSimtKeys + 1)
                            : n_tiles;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kSimtKeys;
    __syncthreads();
    for (int i = threadIdx.x; i < kSimtKeys * D; i += kSimtThreads) {
      const int row = i / D, col = i % D;
      const bool in = k0 + row < t;
      const size_t off = kv_off + static_cast<size_t>(k0 + row) * D + col;
      ks[row][col] = in ? to_f32(k[off]) : 0.f;
      vs[row][col] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
      const int lr = warp * kSimtRowsPerWarp + rr;
      const int row = q0 + lr;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qs[lr][d], ks[lane][d], s);
      s *= scale;
      if (key >= t || (causal && key > row)) s = kNegInf;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[rr], mx);
      const float p = expf(s - mn);
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m[rr] - mn);
      l[rr] = alpha * l[rr] + psum;
      m[rr] = mn;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) acc[rr][cc] *= alpha;
      for (int j = 0; j < kSimtKeys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          acc[rr][cc] = fmaf(pj, vs[j][lane + 32 * cc], acc[rr][cc]);
      }
    }
  }

  TOut* ob = out + static_cast<size_t>(bh) * t * D;
#pragma unroll
  for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
    const int row = q0 + warp * kSimtRowsPerWarp + rr;
    if (row >= t) continue;
    const float safe = l[rr] > 0.f ? l[rr] : 1.f;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      store_one(ob + static_cast<size_t>(row) * D + lane + 32 * cc,
                acc[rr][cc] / safe);
    if (lane == 0) lse[static_cast<size_t>(bh) * t + row] = m[rr] + logf(safe);
  }
}

template <int D, typename TOut>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, float* lse, int bh, int t, int q_per_kv,
                       float scale, int causal, cudaStream_t stream) {
  const dim3 grid((t + kMmaRows - 1) / kMmaRows, bh);
  flash_fwd_mma<D, TOut><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<TOut*>(out), lse, t,
      q_per_kv, scale, causal);
  return cudaGetLastError();
}

template <int D, typename TIn, typename TOut>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* out, float* lse, int bh, int t, int q_per_kv,
                        float scale, int causal, cudaStream_t stream) {
  const dim3 grid((t + kSimtRows - 1) / kSimtRows, bh);
  flash_fwd_simt<D, TIn, TOut><<<grid, kSimtThreads, 0, stream>>>(
      static_cast<const TIn*>(q), static_cast<const TIn*>(k),
      static_cast<const TIn*>(v), static_cast<TOut*>(out), lse, t, q_per_kv,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     float* lse, int bh, int t, int q_per_kv, float scale,
                     int causal, int in_bf16, int out_bf16,
                     cudaStream_t stream) {
  if (in_bf16 && out_bf16)
    return launch_mma<D, __nv_bfloat16>(q, k, v, out, lse, bh, t, q_per_kv,
                                        scale, causal, stream);
  if (in_bf16)
    return launch_mma<D, float>(q, k, v, out, lse, bh, t, q_per_kv, scale,
                                causal, stream);
  if (out_bf16)
    return launch_simt<D, float, __nv_bfloat16>(q, k, v, out, lse, bh, t,
                                                q_per_kv, scale, causal,
                                                stream);
  return launch_simt<D, float, float>(q, k, v, out, lse, bh, t, q_per_kv,
                                      scale, causal, stream);
}

}  // namespace

// q: [bh, t, d]; k, v: [bh / q_per_kv, t, d]; out: [bh, t, d] in the out
// dtype; lse: [bh, t] f32. All contiguous, 16-byte aligned. Dtypes are
// 0 = f32, 1 = bf16. Launches on `stream` and does not synchronise.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int bh, int t, int d,
                             int q_per_kv, float scale, int causal,
                             int in_bf16, int out_bf16, void* stream) {
  if (bh <= 0 || t <= 0 || q_per_kv <= 0 || bh % q_per_kv != 0 ||
      bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  if (d == 64)
    err = dispatch<64>(q, k, v, out, l, bh, t, q_per_kv, scale, causal,
                       in_bf16, out_bf16, s);
  else if (d == 128)
    err = dispatch<128>(q, k, v, out, l, bh, t, q_per_kv, scale, causal,
                        in_bf16, out_bf16, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
