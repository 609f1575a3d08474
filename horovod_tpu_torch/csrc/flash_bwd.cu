// Flash-attention backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's backward
// (horovod_tpu/ops/flash_attention.py::_bwd) is XLA math, and the port
// ran it as dense f32 PyTorch (ops/flash_attention.py::_bwd, which CPU
// tensors still take). It computes the same function as _bwd_rows, from
// the forward's saved logsumexp, with no T x T tensor in device memory:
//
//   P  = exp(Q K^T * scale - lse)           (recomputed, causal-masked)
//   dP = dO V^T
//   dS = P o (dP - delta),  delta = rowsum(dO o out) - g_lse
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K
//
// Folding g_lse into delta is exact algebra: the logsumexp's cotangent
// adds g_lse * P to dS (d lse / d s = p), which is -(-g_lse) * P.
// GQA: kv head h serves query heads h * q_per_kv .. + q_per_kv - 1, and
// its dK/dV sum over them.
//
// What bounds it. At the training shape (bf16, B=4, T=2048, H=32,
// Hkv=8, D=128, causal) the five products are 3.44e11 FLOP against
// ~0.3 GB of q, k, v, out, dO, dq, dk, dv: tensor-core bound (0.347 ms
// at 989 TFLOP/s). Three launches on the training stream:
//
// 1. flash_bwd_prep: one warp a row computes delta (f32) and lse * log2e
//    into [bh, tpad] rows padded to a multiple of 128 (padding rows get
//    delta 0 and lse +inf, so their P is exactly 0 and no kernel masks
//    a ragged query), and, where dO is f32 beside bf16 inputs, rounds dO
//    to bf16 for the tensor cores.
// 2. flash_bwd_dkdv: a block owns one kv head's tile of 128 keys (64 per
//    consumer warpgroup) and walks every query head of its group and
//    every 64-row query tile from the causal diagonal to T. Per tile it
//    recomputes S^T = K Q^T and dP^T = V dO^T (wgmma m64n64, both
//    operands K-major in shared memory), forms P^T and dS^T in
//    registers, and accumulates dV += P^T dO and dK += dS^T Q (wgmma
//    with A from registers: the S^T/dP^T accumulator fragments, rounded
//    to bf16 pairs, are exactly the A fragments, as the forward's P).
//    dK and dV stay in f32 registers across the whole group and are
//    written once: no atomics, no sum over the group afterwards.
// 3. flash_bwd_dq: a block owns 128 query rows of one head (64 per
//    consumer) and walks 64-key tiles up to the diagonal, recomputing S
//    and dP and accumulating dQ += dS K; dq is written once. Seven
//    products in place of five, and the same inputs give bitwise the
//    same dq, dk and dv on every run.
//
// Both product kernels follow the forward's FlashAttention-3 plan: a
// producer warpgroup (one thread issuing TMA loads into an mbarrier
// ring, 24 registers after setmaxnreg) and two consumer warpgroups
// (240 registers); persistent blocks walk the items longest causal
// items first, in a snake order over blocks; masks run only on tiles
// that cross the causal diagonal or the sequence end.
//
// Numerics: q, k, v and dO enter the products in bf16 (dO rounded from
// f32 where out is f32); P and dS are rounded to bf16 as product
// operands; S, P, dP, delta, lse and every accumulator are f32; dq, dk
// and dv are rounded once to bf16. The bound is bwd_kernel_tolerance in
// ops/flash_attention.py. f32 inputs take plain f32 (SIMT) kernels that
// match _bwd's arithmetic to summation order.
//
// C interface: hvd_flash_bwd(...) returns a CUDA error code:
// cudaErrorInvalidValue for arguments it does not take, the error of a
// failed encode, attribute or device query, or cudaGetLastError() after
// a launch.

#include "flash_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Preprocessing: delta, lse * log2e and (where needed) dO in bf16.
// ---------------------------------------------------------------------------

constexpr int kPad = 128;  // delta / lse rows are padded to this multiple
constexpr int kPrepWarps = 8;

template <int D, typename TO, typename TG>
__global__ void __launch_bounds__(32 * kPrepWarps)
    flash_bwd_prep(const TO* __restrict__ out, const TG* __restrict__ g,
                   const float* __restrict__ g_lse,
                   const float* __restrict__ lse, float* __restrict__ lse2,
                   float* __restrict__ delta, __nv_bfloat16* __restrict__ g16,
                   int bh, int t, int tpad) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kPrepWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(bh) * tpad) return;
  const int b = static_cast<int>(row / tpad), r = static_cast<int>(row % tpad);
  if (r >= t) {
    if (lane == 0) {
      lse2[row] = CUDART_INF_F;
      delta[row] = 0.f;
    }
    return;
  }
  const size_t src = static_cast<size_t>(b) * t + r;
  const size_t off = src * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) {
    const float gv = to_f32(g[off + c]);
    acc = fmaf(gv, to_f32(out[off + c]), acc);
    if (g16 != nullptr) g16[off + c] = __float2bfloat16_rn(gv);
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    delta[row] = g_lse != nullptr ? acc - g_lse[src] : acc;
    lse2[row] = lse[src] * kLog2e;
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: TMA, mbarriers and wgmma.
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 2 * 240 + 24 = 3 * 168

template <int ROWS>
constexpr uint32_t kBox = ROWS * kBoxCols * 2;  // one 64-column box

// dK/dV: 128 keys a block, query tiles of 64 rows through the ring.
constexpr int kKvKeys = 128;
constexpr int kKvRows = 64;
constexpr int kKvStages = 2;

template <int D>
struct KvShared {
  static constexpr int kBoxes = D / kBoxCols;
  // Each box is ROWS rows of 128 bytes, swizzled in 1024-byte atoms.
  alignas(1024) __nv_bfloat16 k[kBoxes][kKvKeys * kBoxCols];
  alignas(1024) __nv_bfloat16 v[kBoxes][kKvKeys * kBoxCols];
  alignas(1024) __nv_bfloat16 q[kKvStages][kBoxes][kKvRows * kBoxCols];
  alignas(1024) __nv_bfloat16 g[kKvStages][kBoxes][kKvRows * kBoxCols];
  alignas(16) float lse2[kKvStages][kKvRows];
  alignas(16) float delta[kKvStages][kKvRows];
  uint64_t kv_full;
  uint64_t kv_empty;
  uint64_t full[kKvStages];
  uint64_t empty[kKvStages];
};

// dQ: 128 query rows a block, key tiles of 64 through the ring.
constexpr int kQRows = 128;
constexpr int kQKeys = 64;
constexpr int kQStages = 2;

template <int D>
struct QShared {
  static constexpr int kBoxes = D / kBoxCols;
  alignas(1024) __nv_bfloat16 q[kBoxes][kQRows * kBoxCols];
  alignas(1024) __nv_bfloat16 g[kBoxes][kQRows * kBoxCols];
  alignas(1024) __nv_bfloat16 k[kQStages][kBoxes][kQKeys * kBoxCols];
  alignas(1024) __nv_bfloat16 v[kQStages][kBoxes][kQKeys * kBoxCols];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t full[kQStages];
  uint64_t empty[kQStages];
};

template <typename S>
__device__ __forceinline__ S& aligned_shared(uint8_t* raw) {
  // The swizzle atoms must sit on 1024-byte boundaries.
  const uint32_t a = smem_u32(raw);
  return *reinterpret_cast<S*>(raw + ((1024 - (a & 1023)) & 1023));
}

// Two m64n64 products over D in one wgmma group: s = A1 B1^T and
// p = A2 B2^T, every operand 64 K-major rows, the A rows at a1 / a2 in
// boxes of a_box bytes, the B rows at b1 / b2 in boxes of b_box bytes.
template <int D>
__device__ __forceinline__ void issue_ss_pair(float (&s)[32], float (&p)[32],
                                              uint32_t a1, uint32_t b1,
                                              uint32_t a2, uint32_t b2,
                                              uint32_t a_box,
                                              uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t oa = (kk / 4) * a_box + (kk % 4) * 32;
    const uint32_t ob = (kk / 4) * b_box + (kk % 4) * 32;
    wgmma_m64n64_ss(s, desc_k_major(a1 + oa), desc_k_major(b1 + ob), kk);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t oa = (kk / 4) * a_box + (kk % 4) * 32;
    const uint32_t ob = (kk / 4) * b_box + (kk % 4) * 32;
    wgmma_m64n64_ss(p, desc_k_major(a2 + oa), desc_k_major(b2 + ob), kk);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_g,
                   const float* __restrict__ lse2,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int bkv_count, int t,
                   int tpad, int q_per_kv, float scale, int causal) {
  constexpr int kBoxes = D / kBoxCols;
  constexpr uint32_t kKvBytes = kBoxes * kBox<kKvKeys>;  // K or V
  constexpr uint32_t kRowsBytes = kBoxes * kBox<kKvRows>;  // Q or dO
  constexpr uint32_t kVecBytes = kKvRows * 4;  // lse or delta
  extern __shared__ uint8_t smem_raw[];
  KvShared<D>& sm = aligned_shared<KvShared<D>>(smem_raw);
  const int n_kt = (t + kKvKeys - 1) / kKvKeys;
  const int n_qt = (t + kKvRows - 1) / kKvRows;
  const int n_work = n_kt * bkv_count;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    mbar_init(&sm.kv_empty, 128 * kConsumers);
#pragma unroll
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 128 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Item w: key tile w / bkv_count of kv head w % bkv_count. Key tile 0
  // comes first: under the causal mask it meets the most query tiles.
  // Its query tiles start at the diagonal (the first tile holding a
  // query >= the tile's first key).
  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      int it = 0;
      for (int j = 0; item_of_round(j) < n_work; ++j) {
        const int w = item_of_round(j);
        const int bkv = w % bkv_count, k0 = (w / bkv_count) * kKvKeys;
        mbar_wait(&sm.kv_empty, (j & 1) ^ 1);  // the first pass finds it free
        mbar_expect_tx(&sm.kv_full, 2 * kKvBytes);
#pragma unroll
        for (int b = 0; b < kBoxes; ++b) {
          tma_load(sm.k[b], &tm_k, &sm.kv_full, b * kBoxCols, k0, bkv);
          tma_load(sm.v[b], &tm_v, &sm.kv_full, b * kBoxCols, k0, bkv);
        }
        const int qt0 = causal ? k0 / kKvRows : 0;
        for (int r = 0; r < q_per_kv; ++r) {
          const int bh = bkv * q_per_kv + r;
          for (int qt = qt0; qt < n_qt; ++qt, ++it) {
            const int st = it % kKvStages;
            mbar_wait(&sm.empty[st], ((it / kKvStages) & 1) ^ 1);
            mbar_expect_tx(&sm.full[st], 2 * kRowsBytes + 2 * kVecBytes);
#pragma unroll
            for (int b = 0; b < kBoxes; ++b) {
              tma_load(sm.q[st][b], &tm_q, &sm.full[st], b * kBoxCols,
                       qt * kKvRows, bh);
              tma_load(sm.g[st][b], &tm_g, &sm.full[st], b * kBoxCols,
                       qt * kKvRows, bh);
            }
            const size_t row = static_cast<size_t>(bh) * tpad + qt * kKvRows;
            bulk_load(sm.lse2[st], lse2 + row, kVecBytes, &sm.full[st]);
            bulk_load(sm.delta[st], delta + row, kVecBytes, &sm.full[st]);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    // This thread's rows of the accumulators are keys krow and krow + 8
    // of the tile; its columns of S^T are queries 8j + c2 (+1).
    const int krow = wg * 64 + (tid / 32) * 16 + lane / 4;
    const int c2 = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    // This warpgroup's 64 keys: 8 swizzle atoms into each box.
    const uint32_t k_addr = smem_u32(sm.k[0]) + wg * 64 * 128;
    const uint32_t v_addr = smem_u32(sm.v[0]) + wg * 64 * 128;

    float dk_acc[D / 2], dv_acc[D / 2];
    float s[32], dp[32];
    uint32_t pa[4][4], da[4][4];

    int it = 0;
    for (int j = 0; item_of_round(j) < n_work; ++j) {
      const int w = item_of_round(j);
      const int bkv = w % bkv_count, k0 = (w / bkv_count) * kKvKeys;
      const int key0 = k0 + krow, key1 = key0 + 8;
      const int qt0 = causal ? k0 / kKvRows : 0;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      mbar_wait(&sm.kv_full, j & 1);

      for (int r = 0; r < q_per_kv; ++r) {
        for (int qt = qt0; qt < n_qt; ++qt, ++it) {
          const int st = it % kKvStages;
          const uint32_t q_addr = smem_u32(sm.q[st][0]);
          const uint32_t g_addr = smem_u32(sm.g[st][0]);
          mbar_wait(&sm.full[st], (it / kKvStages) & 1);
          // No branch may sit inside a fence..commit group, or ptxas
          // serialises the wgmma.
          wgmma_fence();
          issue_ss_pair<D>(s, dp, k_addr, q_addr, v_addr, g_addr,
                           kBox<kKvKeys>, kBox<kKvRows>);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);

          // P^T = exp2(S^T * scale * log2e - lse * log2e) and
          // dS^T = P^T o (dP^T - delta); a query past T has lse +inf and
          // delta 0, so its column is 0 with no mask.
          const int q0 = qt * kKvRows;
          const bool masked = causal && q0 < k0 + kKvKeys;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 l2 =
                *reinterpret_cast<const float2*>(&sm.lse2[st][8 * jj + c2]);
            const float2 de =
                *reinterpret_cast<const float2*>(&sm.delta[st][8 * jj + c2]);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float lv = e ? l2.y : l2.x;
              const float dl = e ? de.y : de.x;
              const int qpos = q0 + 8 * jj + c2 + e;
              float p0 = exp2_ftz(fmaf(s[4 * jj + e], scale_log2, -lv));
              float p1 = exp2_ftz(fmaf(s[4 * jj + 2 + e], scale_log2, -lv));
              if (masked) {
                if (key0 > qpos) p0 = 0.f;
                if (key1 > qpos) p1 = 0.f;
              }
              s[4 * jj + e] = p0;
              s[4 * jj + 2 + e] = p1;
              dp[4 * jj + e] = p0 * (dp[4 * jj + e] - dl);
              dp[4 * jj + 2 + e] = p1 * (dp[4 * jj + 2 + e] - dl);
            }
          }
          pack_frags<4>(s, pa);
          pack_frags<4>(dp, da);

          // dV += P^T dO and dK += dS^T Q: the 64 queries are k, the
          // stage's dO and Q tiles the MN-major B operands.
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kKvRows / 16; ++kk)
            wgmma_rs<D>(dv_acc, pa[kk],
                        desc_mn_major(g_addr + kk * 16 * 128, kBox<kKvRows>));
#pragma unroll
          for (int kk = 0; kk < kKvRows / 16; ++kk)
            wgmma_rs<D>(dk_acc, da[kk],
                        desc_mn_major(q_addr + kk * 16 * 128, kBox<kKvRows>));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
          fence_regs(pa);
          fence_regs(da);
          mbar_arrive(&sm.empty[st]);
        }
      }
      mbar_arrive(&sm.kv_empty);

      __nv_bfloat16* dkb = dk + static_cast<size_t>(bkv) * t * D;
      __nv_bfloat16* dvb = dv + static_cast<size_t>(bkv) * t * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int col = 8 * i + c2;
        if (key0 < t) {
          store_pair(dkb + static_cast<size_t>(key0) * D + col,
                     dk_acc[4 * i] * scale, dk_acc[4 * i + 1] * scale);
          store_pair(dvb + static_cast<size_t>(key0) * D + col,
                     dv_acc[4 * i], dv_acc[4 * i + 1]);
        }
        if (key1 < t) {
          store_pair(dkb + static_cast<size_t>(key1) * D + col,
                     dk_acc[4 * i + 2] * scale, dk_acc[4 * i + 3] * scale);
          store_pair(dvb + static_cast<size_t>(key1) * D + col,
                     dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_g,
                 const float* __restrict__ lse2,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int bh_count, int t,
                 int tpad, int q_per_kv, float scale, int causal) {
  constexpr int kBoxes = D / kBoxCols;
  constexpr uint32_t kRowsBytes = kBoxes * kBox<kQRows>;  // Q or dO
  constexpr uint32_t kKeysBytes = kBoxes * kBox<kQKeys>;  // K or V
  extern __shared__ uint8_t smem_raw[];
  QShared<D>& sm = aligned_shared<QShared<D>>(smem_raw);
  const int n_q = (t + kQRows - 1) / kQRows;
  const int n_tiles = (t + kQKeys - 1) / kQKeys;
  const int n_work = n_q * bh_count;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.q_empty, 128 * kConsumers);
#pragma unroll
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 128 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Item w: query tile n_q - 1 - w / bh_count of head w % bh_count, the
  // causal items with the most key tiles first (the forward's order).
  auto item = [&](int w, int& bh, int& q0, int& n_kt) {
    bh = w % bh_count;
    q0 = (n_q - 1 - w / bh_count) * kQRows;
    const int last_row = min(q0 + kQRows, t) - 1;
    n_kt = causal ? min(n_tiles, last_row / kQKeys + 1) : n_tiles;
  };

  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      int it = 0;
      for (int j = 0; item_of_round(j) < n_work; ++j) {
        int bh, q0, n_kt;
        item(item_of_round(j), bh, q0, n_kt);
        const int kvh = bh / q_per_kv;
        mbar_wait(&sm.q_empty, (j & 1) ^ 1);
        mbar_expect_tx(&sm.q_full, 2 * kRowsBytes);
#pragma unroll
        for (int b = 0; b < kBoxes; ++b) {
          tma_load(sm.q[b], &tm_q, &sm.q_full, b * kBoxCols, q0, bh);
          tma_load(sm.g[b], &tm_g, &sm.q_full, b * kBoxCols, q0, bh);
        }
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const int st = it % kQStages;
          mbar_wait(&sm.empty[st], ((it / kQStages) & 1) ^ 1);
          mbar_expect_tx(&sm.full[st], 2 * kKeysBytes);
#pragma unroll
          for (int b = 0; b < kBoxes; ++b) {
            tma_load(sm.k[st][b], &tm_k, &sm.full[st], b * kBoxCols,
                     kt * kQKeys, kvh);
            tma_load(sm.v[st][b], &tm_v, &sm.full[st], b * kBoxCols,
                     kt * kQKeys, kvh);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row = wg * 64 + (tid / 32) * 16 + lane / 4;  // and row + 8
    const int c2 = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    // This warpgroup's 64 query rows: 8 swizzle atoms into each box.
    const uint32_t q_addr = smem_u32(sm.q[0]) + wg * 64 * 128;
    const uint32_t g_addr = smem_u32(sm.g[0]) + wg * 64 * 128;

    float dq_acc[D / 2];
    float s[32], dp[32];
    uint32_t da[4][4];

    int it = 0;
    for (int j = 0; item_of_round(j) < n_work; ++j) {
      int bh, q0, n_kt;
      item(item_of_round(j), bh, q0, n_kt);
      const int r0 = q0 + row, r1 = r0 + 8;
      // Rows past T read the padding: lse +inf, delta 0, so P is 0.
      const float* l2b = lse2 + static_cast<size_t>(bh) * tpad;
      const float* deb = delta + static_cast<size_t>(bh) * tpad;
      const float l0 = l2b[r0], l1 = l2b[r1];
      const float d0 = deb[r0], d1 = deb[r1];
      // A tile with a key past the warpgroup's first row, or past T,
      // needs the mask.
      const int wg_first = q0 + wg * 64;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
      mbar_wait(&sm.q_full, j & 1);

      for (int kt = 0; kt < n_kt; ++kt, ++it) {
        const int st = it % kQStages;
        const uint32_t k_addr = smem_u32(sm.k[st][0]);
        const uint32_t v_addr = smem_u32(sm.v[st][0]);
        mbar_wait(&sm.full[st], (it / kQStages) & 1);
        wgmma_fence();
        issue_ss_pair<D>(s, dp, q_addr, k_addr, g_addr, v_addr,
                         kBox<kQRows>, kBox<kQKeys>);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (kt == n_kt - 1) mbar_arrive(&sm.q_empty);

        const int k0 = kt * kQKeys;
        const bool masked =
            k0 + kQKeys > t || (causal && k0 + kQKeys - 1 > wg_first);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * jj + c2 + e;
            float p0 = exp2_ftz(fmaf(s[4 * jj + e], scale_log2, -l0));
            float p1 = exp2_ftz(fmaf(s[4 * jj + 2 + e], scale_log2, -l1));
            if (masked) {
              if (key >= t || (causal && key > r0)) p0 = 0.f;
              if (key >= t || (causal && key > r1)) p1 = 0.f;
            }
            dp[4 * jj + e] = p0 * (dp[4 * jj + e] - d0);
            dp[4 * jj + 2 + e] = p1 * (dp[4 * jj + 2 + e] - d1);
          }
        }
        pack_frags<4>(dp, da);

        // dQ += dS K: the 64 keys are k, the stage's K tile the MN-major
        // B operand.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQKeys / 16; ++kk)
          wgmma_rs<D>(dq_acc, da[kk],
                      desc_mn_major(k_addr + kk * 16 * 128, kBox<kQKeys>));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_acc);
        fence_regs(da);
        mbar_arrive(&sm.empty[st]);
      }

      __nv_bfloat16* qb = dq + static_cast<size_t>(bh) * t * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int col = 8 * i + c2;
        if (r0 < t)
          store_pair(qb + static_cast<size_t>(r0) * D + col,
                     dq_acc[4 * i] * scale, dq_acc[4 * i + 1] * scale);
        if (r1 < t)
          store_pair(qb + static_cast<size_t>(r1) * D + col,
                     dq_acc[4 * i + 2] * scale, dq_acc[4 * i + 3] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 inputs: plain f32 arithmetic. A warp owns kSimtOwn rows (queries
// for dQ, keys for dK/dV); for each tile of 32 streamed rows, lane j
// takes streamed row j's scores, the warp shares p and ds by shuffles,
// and lane i accumulates columns i, i + 32, ... in f32.
// ---------------------------------------------------------------------------
constexpr int kSimtWarps = 4;
constexpr int kSimtOwn = 2;
constexpr int kSimtRows = kSimtWarps * kSimtOwn;
constexpr int kSimtTile = 32;
constexpr int kSimtThreads = 32 * kSimtWarps;

template <int D, typename TG>
__global__ void __launch_bounds__(kSimtThreads)
    flash_bwd_dq_simt(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const TG* __restrict__ g,
                      const float* __restrict__ lse2,
                      const float* __restrict__ delta, float* __restrict__ dq,
                      int t, int tpad, int q_per_kv, float scale,
                      int causal) {
  __shared__ float qs[kSimtRows][D];
  __shared__ float gs[kSimtRows][D];
  __shared__ float ks[kSimtTile][D + 1];  // +1: lane j reads row j
  __shared__ float vs[kSimtTile][D + 1];
  constexpr int kCols = D / 32;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kSimtRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t q_off = static_cast<size_t>(bh) * t * D;
  const size_t kv_off = static_cast<size_t>(bh / q_per_kv) * t * D;
  const float scale_log2 = scale * kLog2e;

  for (int i = threadIdx.x; i < kSimtRows * D; i += kSimtThreads) {
    const int row = i / D, col = i % D;
    const bool in = q0 + row < t;
    const size_t off = q_off + static_cast<size_t>(q0 + row) * D + col;
    qs[row][col] = in ? q[off] : 0.f;
    gs[row][col] = in ? to_f32(g[off]) : 0.f;
  }
  float acc[kSimtOwn][kCols];
  float l2[kSimtOwn], de[kSimtOwn];
#pragma unroll
  for (int rr = 0; rr < kSimtOwn; ++rr) {
    const int row = q0 + warp * kSimtOwn + rr;  // < tpad
    l2[rr] = lse2[static_cast<size_t>(bh) * tpad + row];
    de[rr] = delta[static_cast<size_t>(bh) * tpad + row];
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc[rr][cc] = 0.f;
  }

  const int n_tiles = (t + kSimtTile - 1) / kSimtTile;
  const int last_row = min(q0 + kSimtRows, t) - 1;
  const int kt_end = causal ? min(n_tiles, last_row / kSimtTile + 1)
                            : n_tiles;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kSimtTile;
    __syncthreads();
    for (int i = threadIdx.x; i < kSimtTile * D; i += kSimtThreads) {
      const int row = i / D, col = i % D;
      const bool in = k0 + row < t;
      const size_t off = kv_off + static_cast<size_t>(k0 + row) * D + col;
      ks[row][col] = in ? k[off] : 0.f;
      vs[row][col] = in ? v[off] : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kSimtOwn; ++rr) {
      const int lr = warp * kSimtOwn + rr;
      const int row = q0 + lr;
      float s = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[lr][d], ks[lane][d], s);
        dpv = fmaf(gs[lr][d], vs[lane][d], dpv);
      }
      float p = exp2f(fmaf(s, scale_log2, -l2[rr]));
      if (key >= t || (causal && key > row)) p = 0.f;
      const float ds = p * (dpv - de[rr]);
      for (int jj = 0; jj < kSimtTile; ++jj) {
        const float dsj = __shfl_sync(0xffffffffu, ds, jj);
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          acc[rr][cc] = fmaf(dsj, ks[jj][lane + 32 * cc], acc[rr][cc]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kSimtOwn; ++rr) {
    const int row = q0 + warp * kSimtOwn + rr;
    if (row >= t) continue;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      dq[q_off + static_cast<size_t>(row) * D + lane + 32 * cc] =
          acc[rr][cc] * scale;
  }
}

template <int D, typename TG>
__global__ void __launch_bounds__(kSimtThreads)
    flash_bwd_dkdv_simt(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, const TG* __restrict__ g,
                        const float* __restrict__ lse2,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int t,
                        int tpad, int q_per_kv, float scale, int causal) {
  __shared__ float ks[kSimtRows][D];
  __shared__ float vs[kSimtRows][D];
  __shared__ float qs[kSimtTile][D + 1];  // +1: lane i reads row i
  __shared__ float gs[kSimtTile][D + 1];
  constexpr int kCols = D / 32;

  const int bkv = blockIdx.y;
  const int k0 = blockIdx.x * kSimtRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t kv_off = static_cast<size_t>(bkv) * t * D;
  const float scale_log2 = scale * kLog2e;

  for (int i = threadIdx.x; i < kSimtRows * D; i += kSimtThreads) {
    const int row = i / D, col = i % D;
    const bool in = k0 + row < t;
    const size_t off = kv_off + static_cast<size_t>(k0 + row) * D + col;
    ks[row][col] = in ? k[off] : 0.f;
    vs[row][col] = in ? v[off] : 0.f;
  }
  float acc_k[kSimtOwn][kCols], acc_v[kSimtOwn][kCols];
#pragma unroll
  for (int rr = 0; rr < kSimtOwn; ++rr)
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc_k[rr][cc] = acc_v[rr][cc] = 0.f;

  const int n_tiles = (t + kSimtTile - 1) / kSimtTile;
  const int qt0 = causal ? k0 / kSimtTile : 0;
  for (int r = 0; r < q_per_kv; ++r) {
    const int bh = bkv * q_per_kv + r;
    const size_t q_off = static_cast<size_t>(bh) * t * D;
    for (int qt = qt0; qt < n_tiles; ++qt) {
      const int qs0 = qt * kSimtTile;
      __syncthreads();
      for (int i = threadIdx.x; i < kSimtTile * D; i += kSimtThreads) {
        const int row = i / D, col = i % D;
        const bool in = qs0 + row < t;
        const size_t off = q_off + static_cast<size_t>(qs0 + row) * D + col;
        qs[row][col] = in ? q[off] : 0.f;
        gs[row][col] = in ? to_f32(g[off]) : 0.f;
      }
      __syncthreads();

      // Lane i takes query qs0 + i; a query past T reads lse +inf.
      const int query = qs0 + lane;
      const float l2 = lse2[static_cast<size_t>(bh) * tpad + query];
      const float de = delta[static_cast<size_t>(bh) * tpad + query];
#pragma unroll
      for (int rr = 0; rr < kSimtOwn; ++rr) {
        const int lr = warp * kSimtOwn + rr;
        const int key = k0 + lr;
        float s = 0.f, dpv = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s = fmaf(qs[lane][d], ks[lr][d], s);
          dpv = fmaf(gs[lane][d], vs[lr][d], dpv);
        }
        float p = exp2f(fmaf(s, scale_log2, -l2));
        if (causal && key > query) p = 0.f;
        const float ds = p * (dpv - de);
        for (int ii = 0; ii < kSimtTile; ++ii) {
          const float pi = __shfl_sync(0xffffffffu, p, ii);
          const float dsi = __shfl_sync(0xffffffffu, ds, ii);
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            acc_v[rr][cc] = fmaf(pi, gs[ii][lane + 32 * cc], acc_v[rr][cc]);
            acc_k[rr][cc] = fmaf(dsi, qs[ii][lane + 32 * cc], acc_k[rr][cc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kSimtOwn; ++rr) {
    const int key = k0 + warp * kSimtOwn + rr;
    if (key >= t) continue;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const size_t off = kv_off + static_cast<size_t>(key) * D + lane + 32 * cc;
      dk[off] = acc_k[rr][cc] * scale;
      dv[off] = acc_v[rr][cc];
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *out, *g, *g_lse, *lse;
  void *dq, *dk, *dv;
  float *lse2, *delta;
  void* g16;  // dO rounded to bf16, or null
  int bh, t, tpad, q_per_kv;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D, typename TO, typename TG>
cudaError_t launch_prep(const Args& a) {
  const long long rows = static_cast<long long>(a.bh) * a.tpad;
  const long long grid = (rows + kPrepWarps - 1) / kPrepWarps;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_prep<D, TO, TG><<<static_cast<unsigned>(grid), 32 * kPrepWarps,
                              0, a.stream>>>(
      static_cast<const TO*>(a.out), static_cast<const TG*>(a.g),
      static_cast<const float*>(a.g_lse), static_cast<const float*>(a.lse),
      a.lse2, a.delta, static_cast<__nv_bfloat16*>(a.g16), a.bh, a.t,
      a.tpad);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const Args& a) {
  const int bkv = a.bh / a.q_per_kv;
  const void* g = a.g16 != nullptr ? a.g16 : a.g;
  CUtensorMap kv_q, kv_k, kv_v, kv_g, q_q, q_k, q_v, q_g;
  cudaError_t err;
  if ((err = encode_map(&kv_q, a.q, a.bh, a.t, D, kKvRows)) != cudaSuccess ||
      (err = encode_map(&kv_g, g, a.bh, a.t, D, kKvRows)) != cudaSuccess ||
      (err = encode_map(&kv_k, a.k, bkv, a.t, D, kKvKeys)) != cudaSuccess ||
      (err = encode_map(&kv_v, a.v, bkv, a.t, D, kKvKeys)) != cudaSuccess ||
      (err = encode_map(&q_q, a.q, a.bh, a.t, D, kQRows)) != cudaSuccess ||
      (err = encode_map(&q_g, g, a.bh, a.t, D, kQRows)) != cudaSuccess ||
      (err = encode_map(&q_k, a.k, bkv, a.t, D, kQKeys)) != cudaSuccess ||
      (err = encode_map(&q_v, a.v, bkv, a.t, D, kQKeys)) != cudaSuccess)
    return err;
  const int kv_smem = static_cast<int>(sizeof(KvShared<D>)) + 1024;  // + align
  const int q_smem = static_cast<int>(sizeof(QShared<D>)) + 1024;
  static std::atomic<int> kv_allowed[kMaxDevices], q_allowed[kMaxDevices];
  int device, sms;
  if ((err = current_device_sms(&device, &sms)) != cudaSuccess ||
      (err = allow_smem(flash_bwd_dkdv<D>, kv_allowed, device, kv_smem)) !=
          cudaSuccess ||
      (err = allow_smem(flash_bwd_dq<D>, q_allowed, device, q_smem)) !=
          cudaSuccess)
    return err;
  // Persistent grids: at most one block per SM walks the work items.
  const long long kv_work =
      static_cast<long long>((a.t + kKvKeys - 1) / kKvKeys) * bkv;
  const long long q_work =
      static_cast<long long>((a.t + kQRows - 1) / kQRows) * a.bh;
  flash_bwd_dkdv<D><<<static_cast<int>(kv_work < sms ? kv_work : sms),
                      kThreads, kv_smem, a.stream>>>(
      kv_q, kv_k, kv_v, kv_g, a.lse2, a.delta,
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      bkv, a.t, a.tpad, a.q_per_kv, a.scale, a.causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq<D><<<static_cast<int>(q_work < sms ? q_work : sms), kThreads,
                    q_smem, a.stream>>>(
      q_q, q_k, q_v, q_g, a.lse2, a.delta, static_cast<__nv_bfloat16*>(a.dq),
      a.bh, a.t, a.tpad, a.q_per_kv, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D, typename TG>
cudaError_t launch_simt(const Args& a) {
  const int bkv = a.bh / a.q_per_kv;
  const dim3 q_grid((a.t + kSimtRows - 1) / kSimtRows, a.bh);
  const dim3 kv_grid((a.t + kSimtRows - 1) / kSimtRows, bkv);
  flash_bwd_dkdv_simt<D, TG><<<kv_grid, kSimtThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const TG*>(a.g), a.lse2,
      a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.t,
      a.tpad, a.q_per_kv, a.scale, a.causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_simt<D, TG><<<q_grid, kSimtThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const TG*>(a.g), a.lse2,
      a.delta, static_cast<float*>(a.dq), a.t, a.tpad, a.q_per_kv, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int D, typename TO, typename TG>
cudaError_t run(const Args& a, int in_bf16) {
  cudaError_t err = launch_prep<D, TO, TG>(a);
  if (err != cudaSuccess) return err;
  if (in_bf16) return launch_wgmma<D>(a);
  return launch_simt<D, TG>(a);
}

template <int D>
cudaError_t dispatch(const Args& a, int in_bf16, int out_bf16, int g_bf16) {
  using bf16 = __nv_bfloat16;
  if (out_bf16 && g_bf16) return run<D, bf16, bf16>(a, in_bf16);
  if (out_bf16) return run<D, bf16, float>(a, in_bf16);
  if (g_bf16) return run<D, float, bf16>(a, in_bf16);
  return run<D, float, float>(a, in_bf16);
}

}  // namespace

// q, dq: [bh, t, d]; k, v, dk, dv: [bh / q_per_kv, t, d], all in the
// input dtype; out, g: [bh, t, d] in their own dtypes; lse and g_lse
// (or null): [bh, t] f32; lse2 and delta: [bh, tpad] f32 scratch, tpad
// t rounded up to a multiple of 128; g16: [bh, t, d] bf16 scratch where
// the inputs are bf16 and g is f32, else null. All contiguous, 16-byte
// aligned. Dtypes are 0 = f32, 1 = bf16. Launches on `stream` and does
// not synchronise.
extern "C" int hvd_flash_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* g,
                             const void* g_lse, const void* lse, void* dq,
                             void* dk, void* dv, void* lse2, void* delta,
                             void* g16, int bh, int t, int tpad, int d,
                             int q_per_kv, float scale, int causal,
                             int in_bf16, int out_bf16, int g_bf16,
                             void* stream) {
  if (bh <= 0 || t <= 0 || q_per_kv <= 0 || bh % q_per_kv != 0 ||
      bh > 65535 || tpad < t || tpad % kPad != 0 ||
      (g16 != nullptr) != (in_bf16 && !g_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.g = g;
  a.g_lse = g_lse;
  a.lse = lse;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse2 = static_cast<float*>(lse2);
  a.delta = static_cast<float*>(delta);
  a.g16 = g16;
  a.bh = bh;
  a.t = t;
  a.tpad = tpad;
  a.q_per_kv = q_per_kv;
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 64)
    err = dispatch<64>(a, in_bf16, out_bf16, g_bf16);
  else if (d == 128)
    err = dispatch<128>(a, in_bf16, out_bf16, g_bf16);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
