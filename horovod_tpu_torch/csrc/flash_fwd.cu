// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel horovod_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd through pl.pallas_call). It computes the same thing:
// for each (batch*head, query row), an online softmax over key/value
// tiles with f32 scores, masks for keys past the sequence end and
// (causal) keys after the query, the running max m and normaliser l,
// out = acc / safe_l and lse = m + log(safe_l), where safe_l = l > 0 ? l
// : 1. GQA reads k/v of head bh / q_per_kv, so grouped k/v are never
// copied per query head.
//
// Translation. The TPU grid ran its kv dimension in order on one core,
// carrying acc/m/l in VMEM scratch across grid steps. Hopper blocks run
// in no order, so the kv dimension becomes a loop inside one thread
// block that keeps acc/m/l in registers. The causal block skip ends that
// loop at the diagonal tile, and the ragged end of the sequence is
// masked in the kernel instead of padding T in device memory.
//
// What bounds it. At the training shape (bf16, B=4, T=2048, H=32,
// Hkv=8, D=128, causal) the work is ~1.4e11 FLOP against ~168 MB of
// q/k/v/out: ~820 FLOP per byte, far above the H100's ~295 FLOP/byte
// ridge, so it is bound by tensor-core operations (bound ~0.14 ms at
// 989 TFLOP/s dense bf16). The design keeps the tensor cores fed and
// everything else off their path (the FlashAttention-3 plan):
//
// - Warp specialisation. A block runs 3 warpgroups: 0 and 1 are
//   consumers (64 query rows each of a 128-row tile), 2 is the producer,
//   in which one thread issues every load. setmaxnreg moves registers
//   from the producer (24) to the consumers (240), which hold 64 f32
//   scores, 32 packed P registers and D/2 f32 outputs each.
// - TMA into a shared-memory ring. Q is loaded once per tile; K and V
//   tiles of 128 keys go through a 2-stage ring with full and empty
//   mbarriers per stage, K and V released separately. The tensor maps
//   are 3-d ({D, T, heads}, innermost first), boxes of 64 columns x 128
//   rows with the 128-byte swizzle; a tile that runs past T reads zeros,
//   never the next head's rows. D=128 is two boxes per tile.
// - wgmma. S = Q K^T is m64n128k16 with both operands K-major in shared
//   memory. O += P V is m64n{D}k16 with A (P) in registers: the S
//   accumulator fragments, rounded to bf16 pairs, are exactly the A
//   fragments of P for each 16-key step, so P never leaves registers.
//   V is the B operand in MN-major form (d is contiguous in its rows).
// - Overlap. Within a warpgroup, S of tile j+1 and P.V of tile j are in
//   flight together and the softmax of tile j+1 runs under P.V. Between
//   the two warpgroups a ping-pong of named barriers lets only one issue
//   its products at a time, so one's softmax runs under the other's.
// - Softmax in registers: each thread owns 2 rows of the fragment; row
//   max and sum reduce over the lane quad; scale * log2(e) is folded into
//   one FMA before ex2; masks run only on an item's last tile.
// - Persistent blocks. One block per SM walks (bh, query tile) items,
//   the longest causal items first, in a snake order over blocks; the
//   producer loads the next item's Q and K/V while the consumers finish
//   the current one, so no block pays a cold start per tile.
//
// Numerics: Q.K^T is exact up to summation order; P is rounded to bf16
// for P.V (the TPU kernel's P.V is f32) — the bound is kernel_tolerance
// in ops/flash_attention.py. f32 inputs take a plain f32 (SIMT) kernel
// with f32 P.V, which matches the TPU kernel's arithmetic to summation
// order (f32 on the tensor cores would mean TF32).
//
// Host side: the tensor maps are encoded for each call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
// library needs no -lcuda; the maps travel as __grid_constant__ kernel
// parameters. The 160 KB of dynamic shared memory (D=128) is allowed with
// cudaFuncSetAttribute and the SM count read once per device
// (flash_common.cuh, which flash_bwd.cu shares). C interface:
// hvd_flash_fwd(...) returns a CUDA error code: cudaErrorInvalidValue for
// arguments it does not take, the error of a failed encode, attribute or
// device query, or cudaGetLastError() after the launch.

#include "flash_common.cuh"

namespace {

constexpr int kBlockM = 128;  // query rows per block, 64 per consumer
constexpr int kBlockN = 128;  // keys per K/V tile
constexpr int kStages = 2;    // K/V ring depth
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxBytes = 128 * kBoxCols * 2;  // one 64-column box
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 2 * 240 + 24 = 3 * 168

template <int D>
struct Shared {
  static constexpr int kBoxes = D / kBoxCols;
  // Each box is 128 rows of 128 bytes, swizzled in 1024-byte atoms.
  alignas(1024) __nv_bfloat16 q[kBoxes][128 * kBoxCols];
  alignas(1024) __nv_bfloat16 k[kStages][kBoxes][128 * kBoxCols];
  alignas(1024) __nv_bfloat16 v[kStages][kBoxes][128 * kBoxCols];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t k_empty[kStages];
  uint64_t v_empty[kStages];
};

// Named barriers 1 and 2 order the two consumer warpgroups' wgmma issue.
constexpr int kTurnBarrier = 1;

// One tile of the online softmax on a warpgroup's S fragment (64 rows x
// 128 keys; this thread holds rows r0 and r0 + 8). Masks keys above
// lim0/lim1 when `masked`, updates the running max m (of unscaled scores)
// and this thread's share of the normaliser l, turns s into p, and
// returns in alpha the factors by which O must be rescaled.
__device__ __forceinline__ void softmax_tile(float (&s)[64], bool masked,
                                             int k0, int lim0, int lim1,
                                             int c2, float scale_log2,
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + c2 + e;
        if (key > lim0) s[4 * j + e] = -CUDART_INF_F;
        if (key > lim1) s[4 * j + 2 + e] = -CUDART_INF_F;
      }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float nb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row spans a lane quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2_ftz((m[r] - mx[r]) * scale_log2);  // 0 on the first tile
    m[r] = mx[r];
    nb[r] = -mx[r] * scale_log2;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[4 * j + i] = exp2_ftz(fmaf(s[4 * j + i], scale_log2, nb[i / 2]));
      sum[i / 2] += s[4 * j + i];
    }
  }
  l[0] = alpha[0] * l[0] + sum[0];
  l[1] = alpha[1] * l[1] + sum[1];
}

// The work items of one launch: (bh, 128-row query tile), longest first.
// Item w is query tile n_q - 1 - w / bh_count of head w % bh_count, so
// the causal items with the most key tiles start first and neighbouring
// blocks share k/v heads in L2. Block b takes one item per round r, in
// snake order (b, then the mirror of b in odd rounds), which evens out
// the blocks' sums of causal item lengths.
struct WorkItem {
  int bh, q0, n_kt;
};

__device__ __forceinline__ WorkItem work_item(int w, int bh_count, int t,
                                              int causal) {
  const int n_q = (t + kBlockM - 1) / kBlockM;
  const int n_tiles = (t + kBlockN - 1) / kBlockN;
  WorkItem it;
  it.bh = w % bh_count;
  it.q0 = (n_q - 1 - w / bh_count) * kBlockM;
  const int last_row = min(it.q0 + kBlockM, t) - 1;
  it.n_kt = causal ? min(n_tiles, last_row / kBlockN + 1) : n_tiles;
  return it;
}

template <int D, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    TOut* __restrict__ out, float* __restrict__ lse,
                    int bh_count, int t, int q_per_kv, float scale,
                    int causal) {
  constexpr int kBoxes = D / kBoxCols;
  constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;
  extern __shared__ uint8_t smem_raw[];
  // The swizzle atoms must sit on 1024-byte boundaries.
  const uint32_t raw = smem_u32(smem_raw);
  Shared<D>& sm = *reinterpret_cast<Shared<D>*>(
      smem_raw + ((1024 - (raw & 1023)) & 1023));
  const int n_work = ((t + kBlockM - 1) / kBlockM) * bh_count;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.q_empty, 128 * kConsumers);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 128 * kConsumers);
      mbar_init(&sm.v_empty[s], 128 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // One if/else for the two roles, never reconverging: setmaxnreg needs
  // every path's register count to be known. Both roles walk the same
  // work items; `it` counts K/V tiles across items, so the ring and its
  // barrier phases run on from one item to the next and the producer
  // loads the next item's Q and first tiles while the consumers finish
  // the current one.
  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      int it = 0;
      for (int j = 0; item_of_round(j) < n_work; ++j) {
        const WorkItem item = work_item(item_of_round(j), bh_count, t, causal);
        const int kvh = item.bh / q_per_kv;
        mbar_wait(&sm.q_empty, (j & 1) ^ 1);  // the first pass finds it free
        mbar_expect_tx(&sm.q_full, kTileBytes);
#pragma unroll
        for (int b = 0; b < kBoxes; ++b)
          tma_load(sm.q[b], &tm_q, &sm.q_full, b * kBoxCols, item.q0,
                   item.bh);
        // K and V of a stage are released separately (K after Q.K^T, V
        // after P.V), so the next K can land while P.V still reads V. A
        // box that runs past T still delivers its full bytes (zeros).
        for (int kt = 0; kt < item.n_kt; ++kt, ++it) {
          const int st = it % kStages;
          const uint32_t ph = (it / kStages) & 1;
          mbar_wait(&sm.k_empty[st], ph ^ 1);
          mbar_expect_tx(&sm.k_full[st], kTileBytes);
#pragma unroll
          for (int b = 0; b < kBoxes; ++b)
            tma_load(sm.k[st][b], &tm_k, &sm.k_full[st], b * kBoxCols,
                     kt * kBlockN, kvh);
          mbar_wait(&sm.v_empty[st], ph ^ 1);
          mbar_expect_tx(&sm.v_full[st], kTileBytes);
#pragma unroll
          for (int b = 0; b < kBoxes; ++b)
            tma_load(sm.v[st][b], &tm_v, &sm.v_full[st], b * kBoxCols,
                     kt * kBlockN, kvh);
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
    // Ping-pong: a warpgroup issues its products only in its turn and
    // then hands the turn over, so one warpgroup's softmax runs while
    // the other's products keep the tensor cores busy.
    const int my_turn = kTurnBarrier + wg;
    const int other_turn = kTurnBarrier + 1 - wg;
    if (wg == 1) bar_arrive(other_turn, 128 * kConsumers);  // 0 goes first

    float s[64];
    float o[D / 2];
    uint32_t pa[kBlockN / 16][4];

    auto issue_qk = [&](int it) {
      const uint32_t k_addr = smem_u32(sm.k[it % kStages][0]);
      mbar_wait(&sm.k_full[it % kStages], (it / kStages) & 1);
      // No branch may sit inside a fence..commit group, or ptxas
      // serialises the wgmma.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_m64n128_ss(s, desc_k_major(q_addr + off),
                         desc_k_major(k_addr + off), kk);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int it) {
      const uint32_t v_addr = smem_u32(sm.v[it % kStages][0]);
      mbar_wait(&sm.v_full[it % kStages], (it / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_rs<D>(o, pa[kk],
                    desc_mn_major(v_addr + kk * 16 * 128, kBoxBytes));
      wgmma_commit();
    };

    int it = 0;
    for (int j = 0; item_of_round(j) < n_work; ++j) {
      const WorkItem item = work_item(item_of_round(j), bh_count, t, causal);
      const int n_kt = item.n_kt;
      const int r0 = item.q0 + row;
      // The item's last tile holds the causal diagonal and the sequence
      // end; no other tile has a masked key.
      const int lim0 = causal ? min(r0, t - 1) : t - 1;
      const int lim1 = causal ? min(r0 + 8, t - 1) : t - 1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      // Running max of the unscaled scores (rows r0, r0 + 8) and this
      // thread's share of the normaliser. Every row below T has key 0
      // unmasked, so its max is finite from the first tile on.
      float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
      float l[2] = {0.f, 0.f};
      float alpha[2];

      // Tile 0: S alone.
      mbar_wait(&sm.q_full, j & 1);
      bar_sync(my_turn, 128 * kConsumers);
      issue_qk(it);
      bar_arrive(other_turn, 128 * kConsumers);
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(&sm.k_empty[it % kStages]);
      if (n_kt == 1) mbar_arrive(&sm.q_empty);
      softmax_tile(s, n_kt == 1, 0, lim0, lim1, c2, scale_log2, m, l, alpha);
      pack_frags<kBlockN / 16>(s, pa);

      // Tile kt: S_kt = Q K_kt^T and O += P_{kt-1} V_{kt-1} run together;
      // the softmax of S_kt runs while P.V is still on the tensor cores,
      // and O is rescaled once P.V is done.
      for (int kt = 1; kt < n_kt; ++kt) {
        bar_sync(my_turn, 128 * kConsumers);
        issue_qk(it + kt);
        issue_pv(it + kt - 1);
        bar_arrive(other_turn, 128 * kConsumers);
        wgmma_wait<1>();
        fence_regs(s);
        mbar_arrive(&sm.k_empty[(it + kt) % kStages]);
        if (kt == n_kt - 1) mbar_arrive(&sm.q_empty);
        softmax_tile(s, kt == n_kt - 1, kt * kBlockN, lim0, lim1, c2,
                     scale_log2, m, l, alpha);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive(&sm.v_empty[(it + kt - 1) % kStages]);
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          o[4 * i] *= alpha[0];
          o[4 * i + 1] *= alpha[0];
          o[4 * i + 2] *= alpha[1];
          o[4 * i + 3] *= alpha[1];
        }
        pack_frags<kBlockN / 16>(s, pa);
      }

      // The last P.V. After the block's last item, warpgroup 1 hands over
      // no turn, so no arrival is left pending on the barrier at exit.
      bar_sync(my_turn, 128 * kConsumers);
      issue_pv(it + n_kt - 1);
      if (wg == 0 || item_of_round(j + 1) < n_work)
        bar_arrive(other_turn, 128 * kConsumers);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(&sm.v_empty[(it + n_kt - 1) % kStages]);
      it += n_kt;

      // The row sums were kept per thread; a row's total is its quad's
      // sum.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const float safe0 = l[0] > 0.f ? l[0] : 1.f;
      const float safe1 = l[1] > 0.f ? l[1] : 1.f;
      const float inv0 = 1.f / safe0, inv1 = 1.f / safe1;
      const int r1 = r0 + 8;
      TOut* ob = out + static_cast<size_t>(item.bh) * t * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int col = 8 * i + c2;
        if (r0 < t)
          store_pair(ob + static_cast<size_t>(r0) * D + col,
                     o[4 * i] * inv0, o[4 * i + 1] * inv0);
        if (r1 < t)
          store_pair(ob + static_cast<size_t>(r1) * D + col,
                     o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
      }
      if (lane % 4 == 0) {
        float* lb = lse + static_cast<size_t>(item.bh) * t;
        if (r0 < t) lb[r0] = m[0] * scale + logf(safe0);
        if (r1 < t) lb[r1] = m[1] * scale + logf(safe1);
      }
    }
  }
}

template <int D, typename TOut>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* lse, int bh, int t, int q_per_kv,
                         float scale, int causal, cudaStream_t stream) {
  if (!(scale > 0.f)) return cudaErrorInvalidValue;  // max of raw scores
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err;
  if ((err = encode_map(&tm_q, q, bh, t, D, kBlockM)) != cudaSuccess ||
      (err = encode_map(&tm_k, k, bh / q_per_kv, t, D, kBlockN)) !=
          cudaSuccess ||
      (err = encode_map(&tm_v, v, bh / q_per_kv, t, D, kBlockN)) !=
          cudaSuccess)
    return err;
  const int smem = static_cast<int>(sizeof(Shared<D>)) + 1024;  // + align
  // A persistent grid: one block per SM walks the work items.
  static std::atomic<int> allowed[kMaxDevices];
  int device, sms;
  if ((err = current_device_sms(&device, &sms)) != cudaSuccess ||
      (err = allow_smem(flash_fwd_wgmma<D, TOut>, allowed, device, smem)) !=
          cudaSuccess)
    return err;
  const long long n_work =
      static_cast<long long>((t + kBlockM - 1) / kBlockM) * bh;
  const int grid = static_cast<int>(n_work < sms ? n_work : sms);
  flash_fwd_wgmma<D, TOut><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<TOut*>(out), lse, bh, t, q_per_kv, scale,
      causal);
  return cudaGetLastError();
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
    return launch_wgmma<D, __nv_bfloat16>(q, k, v, out, lse, bh, t, q_per_kv,
                                          scale, causal, stream);
  if (in_bf16)
    return launch_wgmma<D, float>(q, k, v, out, lse, bh, t, q_per_kv, scale,
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