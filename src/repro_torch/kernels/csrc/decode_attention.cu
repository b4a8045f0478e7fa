// Flash-decoding for Hopper (sm_90a): one query token per row against
// its KV cache, with a per-row cache length.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_dec_kernel, launched by decode_attention_bhgd). It computes the same
// function: for each (b, kv head) the G query heads that share the kv
// head attend to cache rows [lo, cache_len[b]), lo = cache_len[b] -
// window with a window and 0 without, with q scaled by 1/sqrt(hd), the
// tanh softcap, and an online softmax in f32. Unlike the TPU kernel,
// whose cache_len is one scalar in SMEM, cache_len is a (B,) int32
// device tensor, so the serving engine's per-row positions reach the
// kernel. It is clamped to [0, S], so a stale length of an idle slot
// stays in bounds. The output has the cache's dtype, as the plain
// decode_attention does; a row with no visible key comes out 0.
//
// Layout: q (B,1,Hq,hd) f32 or bf16, caches (B,S,Hkv,hd) f32 or bf16,
// out (B,1,Hq,hd) in the cache dtype. hd <= 256, hd % 4 == 0, G <= 16,
// and hd % 16 == 0 when G > 8.
//
// What bounds it on the card: the bytes of the cache rows it reads. Each
// k/v element serves G = Hq/Hkv query heads only, far below the card's
// ~295 operations per byte, so it is a streaming read, and what sets its
// time is how many bytes are in flight across the SMs and how long the
// chain of dependent steps after them is. The TPU kernel walks a row's
// cache in kv_block segments one after another, carrying (m, l, acc) in
// scratch; here the cache length is split over blocks (split-K), one
// launch in all:
//  - a block per (kv head, b, split) owns split_rows consecutive cache
//    rows of one (b, kv head); a block whose rows lie wholly outside [lo,
//    clen) reads no row and only takes its part of the merge;
//  - G <= 8 (decode_split_kernel, CUDA cores): each of 8 warps takes
//    chunks of UNROLL consecutive rows (8 at hd <= 128, 4 otherwise); a
//    lane loads one or two 16-byte quads of each k and v row, so a warp
//    reads a whole row in one coalesced transaction; the G query heads
//    reuse each loaded row from registers; a score is a 5-step
//    xor-shuffle reduction;
//  - G in (8, 16] (decode_split_tc_kernel, tensor cores: glm4-9b's 32 q
//    heads over 2 kv heads): the 16 query heads are the 16 rows of
//    mma.sync m16n8k8 (tf32 in, f32 sums). 8 warps: the work of a block
//    is a chain of dependent steps, spread over the warps (16 warps, a
//    stage of 64 keys at hd 128, ran slower: 512-thread blocks in
//    clusters of 16). q is loaded first, beside cache_len. The block
//    walks its rows in stages of 64 keys at hd 64, 32 at hd 128 and 16
//    at hd 256, double-buffered in shared memory by 16-byte cp.async
//    (zero-filled past the row's end). A stage's 16-key chunk goes to a
//    group of hd / 32 warps: each forms q·k over 32 of the columns (S =
//    Q·Kᵀ, two n-tiles of 8 keys) and the group sums the parts in order
//    through shared memory; each warp runs the online softmax on the S
//    fragments (a row's max takes 2 quad shuffles per 16 keys, its sum
//    stays per lane until the end) and P·V for its 32 output columns, 8
//    keys a k-step, with P as the A operand straight from the S
//    fragments (key 8j + 2t in slot t, 8j + 2t + 1 in slot t + 4) and V
//    as B: 16 accumulators a lane. Columns are permuted (the same way for
//    q and K) so that a fragment is one 16-byte (f32) or 8-byte (bf16)
//    shared load, and the 16-byte chunks of a staged row are XOR-swizzled
//    so that no load conflicts on a bank. f32 operands enter as 3xTF32
//    (big = tf32(x), small = tf32(x - big), 22 significant bits; the
//    products small·big, big·small and big·big), bf16 ones as they are:
//    2 products a k-step for a bf16 q against an f32 cache, 3 for P·V.
//    bf16 terms were tried first (3 terms, 6 products, as K3's wgmma):
//    a stage's time is its instruction chain, and splitting every K and
//    V element into three packed bf16 terms was most of it; tf32 terms
//    need no packing. The product is q·k, scaled by 1/sqrt(hd) after: a
//    bf16 q stays one term, f32-equal to scaling q first;
//  - the merge, in the same launch; a (kv head, b)'s splits are at most
//    16. Each live block first merges its warps' (m, l, acc) in shared
//    memory (log-sum-exp). The splits then merge in split order by the
//    rule of repro/models/attention.py's decode_attention_context_parallel:
//    M = max m_j, out = sum acc_j e^(m_j - M) / max(sum l_j e^(m_j - M),
//    1e-30), 0 for a row with no visible key.
//    - G <= 8 (finish_counted): a row with one live split is written
//      from its block; otherwise each live block writes its partial to an
//      f32 scratch, (B, Hkv, nsplit, slot): acc (G, hd), m (G), l (G),
//      padded to 4 floats; a __threadfence() and an atomicAdd on a
//      per-(b, kv head) int32 counter follow, and the block that counts
//      the last live split (recomputed from cache_len) merges, reading
//      the partials through L2 (__ldcg), every split's loads in flight at
//      once, and sets the counter back to 0. The counters are the
//      wrapper's, zeroed once when made: no launch zeroes them.
//    - G = 16 (finish_cluster): a row's splits are one thread-block
//      cluster (non-portable above 8 blocks). After a cluster barrier
//      each block takes 1/nsplit of the G·hd outputs and reads the other
//      blocks' states through distributed shared memory
//      (ld.shared::cluster); a second barrier keeps every block's state
//      alive until the others have read it. A row's partials are 8 KB a
//      split at G = 16, hd 128: one block reading all of them through L2
//      (the counted merge, tried first) made the merge the kernel's
//      longest step; spread over the cluster, each block reads 1/nsplit
//      of them from its neighbours. At G <= 8 the counted merge reads
//      little, and a cluster per row (16 blocks each for internlm2's 32
//      rows) ran slower on the card.
//    No second launch: the call is one kernel (capturable in a CUDA
//    graph).
// split_rows is the caller's, a function of the shapes only
// (decode_attention/ops.py::split_rows), so the host never reads
// cache_len. split_rows = S is the one-split schedule (a block per
// (b, kv head)).
#include "hopper.cuh"

namespace repro {
namespace {

constexpr int WARPS = 8;                  // the CUDA-core split pass
constexpr int THREADS = WARPS * 32;
constexpr int TC_WARPS = 8;               // the tensor-core split pass
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int MAX_SPLITS = 16;            // blocks of a cluster (non-portable above 8)

// A (b, kv head)'s visible rows [lo, clen) and its live splits [j0, j1)
struct Span {
  int clen, lo, j0, j1;
};

__device__ __forceinline__ Span span_of(const int* cache_len, int b, int S, int window,
                                        int rows) {
  Span sp;
  sp.clen = min(max(cache_len[b], 0), S);
  sp.lo = window > 0 ? max(0, sp.clen - window) : 0;
  sp.j0 = sp.lo / rows;
  sp.j1 = sp.clen > sp.lo ? (sp.clen - 1) / rows + 1 : sp.j0;
  return sp;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of the same variable in block `rank`
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a) : "memory");
  return v;
}

// The split's state from the NW warp states in shared memory, s_acc
// (NW, G, hd), s_m and s_l (NW, G) (a warp that saw no row holds m =
// NEG_INF, l = 0, acc = 0), by the log-sum-exp rule: per head M = max
// m_w, c_w = e^(m_w - M), l = sum l_w c_w, acc = sum acc_w c_w in warp
// order, into s_acc's first slot and st_m, st_l. Then the cluster's merge
// (the blocks of one cluster are the splits of one (b, kv head)): each
// block takes a slice of the G·hd outputs and merges them over the live
// splits [j0, j1), in split order, reading the other blocks' states from
// their shared memory, M = max m_j, out = sum acc_j e^(m_j - M) /
// max(sum l_j e^(m_j - M), 1e-30), 0 for a row with no visible key.
// Every block of the cluster calls it (a block with no live row with
// live = false), and none leaves before the others have read it.
template <typename TC, int NW, int NT>
__device__ void finish_cluster(float* s_acc, const float* s_m, const float* s_l, bool live,
                               TC* __restrict__ o, int b, int hk, int Hkv, int G, int hd,
                               int split, int nsplit, const Span& sp) {
  static_assert(NW <= 16, "at most 16 warp states");
  __shared__ float st_m[16], st_l[16];                         // this split's m, l
  __shared__ float s_w[16 * 16];                               // c_w per (w, head)
  __shared__ float s_c[MAX_SPLITS * 16], s_den[16];            // c_j per (j, head)
  const int n4 = G * hd / 4;
  if (live) {
    if (threadIdx.x < G) {
      const int g = threadIdx.x;
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < NW; ++w) mx = fmaxf(mx, s_m[w * G + g]);
      float den = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float c = expf(s_m[w * G + g] - mx);
        s_w[w * 16 + g] = c;
        den += s_l[w * G + g] * c;
      }
      st_m[g] = mx;
      st_l[g] = den;
    }
    __syncthreads();
    for (int o4 = threadIdx.x; o4 < n4; o4 += NT) {
      const int g = o4 * 4 / hd;
      float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < NW; ++w)
        num = axpy4(num, 1.f, s_w[w * 16 + g],
                    *reinterpret_cast<const float4*>(s_acc + w * G * hd + o4 * 4));
      *reinterpret_cast<float4*>(s_acc + o4 * 4) = num;       // in place: slot 0
    }
  }
  cluster_sync();                      // every live split's state is written
  // the weights of the live splits per head
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mj[MAX_SPLITS], lj[MAX_SPLITS];
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      mj[j] = NEG_INF;
      lj[j] = 0.f;
      if (j >= sp.j0 && j < sp.j1) {
        mj[j] = ld_cluster(remote(st_m + g, j));
        lj[j] = ld_cluster(remote(st_l + g, j));
      }
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) mx = fmaxf(mx, mj[j]);
    float den = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      const float c = j >= sp.j0 && j < sp.j1 ? expf(mj[j] - mx) : 0.f;
      s_c[j * 16 + g] = c;
      den += lj[j] * c;
    }
    s_den[g] = den;
  }
  __syncthreads();
  // this block's slice of the outputs, a float4 a thread
  const int per = (n4 + nsplit - 1) / nsplit;
  TC* op = o + (static_cast<long>(b) * Hkv + hk) * G * hd;
  for (int o4 = split * per + threadIdx.x; o4 < min(n4, split * per + per); o4 += NT) {
    const int g = o4 * 4 / hd;
    float4 a[MAX_SPLITS];
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j)
      if (j >= sp.j0 && j < sp.j1) a[j] = ld_cluster4(remote(s_acc + o4 * 4, j));
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j)
      if (j >= sp.j0 && j < sp.j1) num = axpy4(num, 1.f, s_c[j * 16 + g], a[j]);
    const float dd = fmaxf(s_den[g], 1e-30f);
    store4(op + o4 * 4, make_float4(num.x / dd, num.y / dd, num.z / dd, num.w / dd));
  }
  cluster_sync();                      // the others have read this block's state
}

// floats of one split's partial in the scratch: acc (G, hd), m (G), l (G),
// padded to 4
__host__ __device__ __forceinline__ long slot_floats(int G, int hd) {
  return static_cast<long>(G) * hd + ((2 * G + 3) & ~3);
}

// The split's state from the NW warp states in shared memory (as
// finish_cluster's). One live split: the output, acc / l. Otherwise the
// partial into the scratch, a __threadfence() and an atomicAdd on the
// (b, kv head)'s counter; the block that counts the last live split
// merges them all in split order (M = max m_j, then sum acc_j e^(m_j - M)
// and l_j e^(m_j - M), the weights in shared memory and every split's
// loads in flight at once, through L2) and sets the counter back to 0.
template <typename TC, int NW, int NT, int OUT4>
__device__ void finish_counted(const float* s_acc, const float* s_m, const float* s_l,
                               float* __restrict__ part, int* __restrict__ counters,
                               TC* __restrict__ o, int b, int hk, int Hkv, int G, int hd,
                               int split, int nsplit, const Span& sp) {
  static_assert(NW <= 16, "at most 16 warp states");
  __shared__ int s_last;
  __shared__ float s_w[16 * 16], s_bl[16];           // c_w per (w, head); l per head
  __shared__ float s_c[MAX_SPLITS * 16], s_cl[MAX_SPLITS * 16];
  const long slot = slot_floats(G, hd);
  const long bh = static_cast<long>(b) * Hkv + hk;
  const int gh = G * hd;
  float* pb = part + bh * nsplit * slot;
  TC* op = o + bh * gh;
  const bool single = sp.j1 - sp.j0 == 1;
  float* pp = pb + split * slot;
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, s_m[w * G + g]);
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(s_m[w * G + g] - mx);
      s_w[w * 16 + g] = c;
      den += s_l[w * G + g] * c;
    }
    s_bl[g] = den;
    if (!single) {
      pp[gh + g] = mx;
      pp[gh + G + g] = den;
    }
  }
  __syncthreads();
  for (int o4 = threadIdx.x; o4 * 4 < gh; o4 += NT) {
    const int g = o4 * 4 / hd;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NW; ++w)
      num = axpy4(num, 1.f, s_w[w * 16 + g],
                  *reinterpret_cast<const float4*>(s_acc + w * gh + o4 * 4));
    if (single) {
      const float dd = fmaxf(s_bl[g], 1e-30f);
      store4(op + o4 * 4, make_float4(num.x / dd, num.y / dd, num.z / dd, num.w / dd));
    } else {
      *reinterpret_cast<float4*>(pp + o4 * 4) = num;
    }
  }
  if (single) return;
  // publish the partial, then count it; the last block sees every one
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counters + bh, 1) == sp.j1 - sp.j0 - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the weights: M per head, then c_j and l_j per (split, head)
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mj[MAX_SPLITS], lj[MAX_SPLITS];
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      const bool in = j >= sp.j0 && j < sp.j1;
      mj[j] = in ? __ldcg(pb + j * slot + gh + g) : NEG_INF;
      lj[j] = in ? __ldcg(pb + j * slot + gh + G + g) : 0.f;
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) mx = fmaxf(mx, mj[j]);
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      s_c[j * 16 + g] = j >= sp.j0 && j < sp.j1 ? expf(mj[j] - mx) : 0.f;
      s_cl[j * 16 + g] = lj[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < OUT4; ++k) {
    const int o4 = threadIdx.x + k * NT;
    if (o4 * 4 >= gh) break;
    const int g = o4 * 4 / hd;
    float4 a[MAX_SPLITS];
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j)
      if (j >= sp.j0 && j < sp.j1)
        a[j] = __ldcg(reinterpret_cast<const float4*>(pb + j * slot + o4 * 4));
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j)
      if (j >= sp.j0 && j < sp.j1) {
        const float c = s_c[j * 16 + g];
        num = axpy4(num, 1.f, c, a[j]);
        den += s_cl[j * 16 + g] * c;
      }
    const float dd = fmaxf(den, 1e-30f);
    store4(op + o4 * 4, make_float4(num.x / dd, num.y / dd, num.z / dd, num.w / dd));
  }
  if (threadIdx.x == 0) counters[bh] = 0;      // every live split has counted
}

// ---------------------------------------------------------------------
// G <= 8: the CUDA-core split pass
// ---------------------------------------------------------------------

template <typename TC, int HD, int GT>
__global__ void __launch_bounds__(THREADS, (HD <= 128 && GT <= 2) ? 2 : 1)
decode_split_kernel(const void* __restrict__ q, int q_bf16,
                    const TC* __restrict__ kc, const TC* __restrict__ vc,
                    const int* __restrict__ cache_len, float* __restrict__ part,
                    int* __restrict__ counters, TC* __restrict__ o,
                    int S, int Hq, int Hkv, int hd, int G, int rows, int nsplit,
                    int window, float scale, float softcap) {
  constexpr int QPL = (HD + 127) / 128;          // quads per lane
  constexpr int UNROLL = QPL == 1 ? 8 : 4;       // cache rows per warp per step
  extern __shared__ __align__(16) float smem[];
  float* s_acc = smem;                           // the warps' states (WARPS, G, hd)
  float* s_m = s_acc + WARPS * G * hd;
  float* s_l = s_m + WARPS * G;

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nquad = hd / 4;
  // q first, beside cache_len (it waits on nothing)
  float4 qf[GT][QPL];
  const long q_off = (static_cast<long>(b) * Hq + static_cast<long>(hk) * G) * hd;
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int t = 0; t < QPL; ++t) {
      const int quad = lane + 32 * t;
      qf[g][t] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < G && quad < nquad) {
        const long off = q_off + static_cast<long>(g) * hd + 4 * quad;
        qf[g][t] = q_bf16 ? load4(static_cast<const __nv_bfloat16*>(q) + off)
                          : load4(static_cast<const float*>(q) + off);
      }
    }
  const Span sp = span_of(cache_len, b, S, window, rows);
  if (split < sp.j0 || split >= sp.j1) {                 // block-uniform: no row to read
    if (sp.j1 == sp.j0 && split == 0) {                  // no visible key: 0
      TC* op = o + (static_cast<long>(b) * Hkv + hk) * G * hd;
      for (int i = threadIdx.x; i < G * hd; i += THREADS) store1(op + i, 0.f);
    }
    return;
  }
  {
    const int first = max(split * rows, sp.lo), end = min(split * rows + rows, sp.clen);
    float4 acc[GT][QPL];
    float m[GT], l[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int t = 0; t < QPL; ++t) {
        acc[g][t] = make_float4(0.f, 0.f, 0.f, 0.f);
        qf[g][t] = scale4(qf[g][t], scale);
      }
    }

    const long rstride = static_cast<long>(Hkv) * hd;     // one cache row, all kv heads
    const TC* kb = kc + static_cast<long>(b) * S * rstride + static_cast<long>(hk) * hd;
    const TC* vb = vc + static_cast<long>(b) * S * rstride + static_cast<long>(hk) * hd;

    for (int base = first + warp * UNROLL; base < end; base += WARPS * UNROLL) {
      float4 kk[UNROLL][QPL], vv[UNROLL][QPL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int t = 0; t < QPL; ++t) {
          const int quad = lane + 32 * t;
          kk[u][t] = vv[u][t] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (base + u < end && quad < nquad) {
            kk[u][t] = load4(kb + (base + u) * rstride + 4 * quad);
            vv[u][t] = load4(vb + (base + u) * rstride + 4 * quad);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g >= G) break;                          // warp-uniform
        float s[UNROLL];
        float m_new = m[g];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int t = 0; t < QPL; ++t) dot += dot4(qf[g][t], kk[u][t]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          s[u] = base + u < end ? apply_softcap(dot, softcap) : NEG_INF;
          m_new = fmaxf(m_new, s[u]);
        }
        const float corr = expf(m[g] - m_new);
        l[g] *= corr;
#pragma unroll
        for (int t = 0; t < QPL; ++t) acc[g][t] = scale4(acc[g][t], corr);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const float p = base + u < end ? expf(s[u] - m_new) : 0.f;
          l[g] += p;
#pragma unroll
          for (int t = 0; t < QPL; ++t) acc[g][t] = axpy4(acc[g][t], 1.f, p, vv[u][t]);
        }
        m[g] = m_new;
      }
    }

    // the warps' states into shared memory
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int t = 0; t < QPL; ++t) {
        const int quad = lane + 32 * t;
        if (quad < nquad) store4(s_acc + (warp * G + g) * hd + 4 * quad, acc[g][t]);
      }
      if (lane == 0) {
        s_m[warp * G + g] = m[g];
        s_l[warp * G + g] = l[g];
      }
    }
    __syncthreads();
  }
  finish_counted<TC, WARPS, THREADS, (GT * HD / 4 + THREADS - 1) / THREADS>(
      s_acc, s_m, s_l, part, counters, o, b, hk, Hkv, G, hd, split, nsplit, sp);
}

// ---------------------------------------------------------------------
// G in (8, 16]: the tensor-core split pass
// ---------------------------------------------------------------------

// d += a b, m16n8k8, tf32 operands, f32 sums
__device__ __forceinline__ void mma_1688(float (&d)[4], const uint4& a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x as the tensor cores take it (3xTF32): big = tf32(x), small =
// tf32(x - big), 22 significant bits; a bf16 value is its own big term
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// d += a b over the products of terms big/small of a (na of them) and b
// (nb): small·big ones first, then big·big (i + j <= 1)
__device__ __forceinline__ void mma_terms(float (&d)[4], const uint4 (&a)[2], int na,
                                          const uint32_t (&b0)[2], const uint32_t (&b1)[2],
                                          int nb) {
  if (nb > 1) mma_1688(d, a[0], b0[1], b1[1]);
  if (na > 1) mma_1688(d, a[1], b0[0], b1[0]);
  mma_1688(d, a[0], b0[0], b1[0]);
}

// 16 bytes from global to shared memory; bytes = 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group of this thread's copies is in flight
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The 16-byte chunk c of staged row r lies at chunk c ^ swz(r): the rows a
// fragment load touches at once (r, r+1 for K; 4 rows two apart for V)
// fall on distinct banks
__device__ __forceinline__ int swz(int r) { return (((r >> 1) & 3) << 1) ^ ((r & 1) << 2); }

// a barrier of the nthreads threads (whole warps) that use id
__device__ __forceinline__ void named_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

// 4 consecutive values of a staged row at element e as f32 (bf16 widened)
__device__ __forceinline__ float4 staged4(const unsigned char* row, int e, int r, float) {
  return *reinterpret_cast<const float4*>(row + (((e >> 2) ^ swz(r)) * 16));
}
__device__ __forceinline__ float4 staged4(const unsigned char* row, int e, int r,
                                          __nv_bfloat16) {
  const uint2 x = *reinterpret_cast<const uint2*>(row + (((e >> 3) ^ swz(r)) * 16) +
                                                  ((e >> 2) & 1) * 8);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  return make_float4(a.x, a.y, c.x, c.y);
}

template <typename TC, int HD>
struct TcShape {
  static constexpr int HSPLIT = HD / 32;            // warps sharing a 16-key chunk
  static constexpr int NG = TC_WARPS / HSPLIT;      // 16-key chunks a stage
  static constexpr int KS = 16 * NG;                // keys a stage
  static constexpr int KS8 = HD / 8;                // k-steps of q·k, 4 a warp
  static constexpr int EL = sizeof(TC);
  static constexpr int CH = 16 / EL;                // elements a 16-byte chunk
  static constexpr int RC = HD / CH;                // 16-byte chunks a staged row
  static constexpr int TERMS = EL == 4 ? 2 : 1;     // tf32 terms of a cache value
  static constexpr int STAGE_BYTES = 2 * KS * HD * EL;   // K and V of a stage
  static constexpr int Q_BYTES = 2 * KS8 * 32 * 16;      // q's A fragments, 2 terms
  static constexpr int X_BYTES = TC_WARPS * 8 * 32 * 4;  // the warps' parts of S
  static constexpr int SMEM = 2 * STAGE_BYTES + Q_BYTES + X_BYTES;
};

template <typename TC, int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
decode_split_tc_kernel(const void* __restrict__ q, int q_bf16,
                       const TC* __restrict__ kc, const TC* __restrict__ vc,
                       const int* __restrict__ cache_len, TC* __restrict__ o,
                       int S, int Hq, int Hkv, int hd, int G, int rows, int nsplit,
                       int window, float scale, float softcap) {
  using T = TcShape<TC, HD>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* stage = tc_smem;                          // [2][K|V][KS][HD]
  uint4* sq = reinterpret_cast<uint4*>(tc_smem + 2 * T::STAGE_BYTES);  // [2][KS8][32]
  float* sx = reinterpret_cast<float*>(tc_smem + 2 * T::STAGE_BYTES + T::Q_BYTES);
  // the groups' states once the stages are done: s_acc (NG, G, hd), s_m, s_l (NG, G)
  float* s_acc = reinterpret_cast<float*>(tc_smem);
  float* s_m = s_acc + T::NG * G * hd;
  float* s_l = s_m + T::NG * G;

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, t4 = lane & 3;

  // q first, beside cache_len (it waits on nothing): rows gid, gid+8 at
  // columns 16ks + 4t..+3 of the 16-column blocks ks = warp + 8e
  constexpr int QE = (HD / 16 + TC_WARPS - 1) / TC_WARPS;
  float4 qv[QE][2];
  const long q_off = (static_cast<long>(b) * Hq + static_cast<long>(hk) * G) * hd;
#pragma unroll
  for (int e = 0; e < QE; ++e)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = gid + 8 * r, qd = 16 * (warp + TC_WARPS * e) + 4 * t4;
      const bool ok = qd < hd && g < G;
      const long off = q_off + (ok ? static_cast<long>(g) * hd + qd : 0);
      qv[e][r] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok)
        qv[e][r] = q_bf16 ? load4(static_cast<const __nv_bfloat16*>(q) + off)
                          : load4(static_cast<const float*>(q) + off);
    }

  const Span sp = span_of(cache_len, b, S, window, rows);
  const bool live = split >= sp.j0 && split < sp.j1;       // block-uniform
  if (live) {
    const int first = max(split * rows, sp.lo), end = min(split * rows + rows, sp.clen);
    // warp group wg takes the stage's 16-key chunk wg; its warp h forms q·k
    // over columns [32h, 32h + 32) and owns those output columns of P·V
    const int wg = warp / T::HSPLIT, h = warp % T::HSPLIT, dbase = 32 * h;
    const int nqt = q_bf16 ? 1 : 2;

    const long rstride = static_cast<long>(Hkv) * hd;
    const TC* kb = kc + static_cast<long>(b) * S * rstride + static_cast<long>(hk) * hd;
    const TC* vb = vc + static_cast<long>(b) * S * rstride + static_cast<long>(hk) * hd;

    // a stage's rows [base, base + KS) into buffer buf, zero past end and hd
    auto load_stage = [&](int buf, int base) {
      const uint32_t dst0 = smem_u32(stage + buf * T::STAGE_BYTES);
#pragma unroll 2
      for (int i = threadIdx.x; i < 2 * T::KS * T::RC; i += TC_THREADS) {
        const int kv = i / (T::KS * T::RC), r = (i / T::RC) % T::KS, c = i % T::RC;
        const int pos = base + r;
        const bool ok = pos < end && c * T::CH < hd;
        const TC* src = (kv ? vb : kb) + static_cast<long>(ok ? pos : first) * rstride +
                        (ok ? c * T::CH : 0);
        const uint32_t dst = dst0 + ((kv * T::KS + r) * T::RC + (c ^ swz(r))) * 16;
        cp_async16(dst, src, ok ? 16 : 0);
      }
    };
    const int nstage = (end - first + T::KS - 1) / T::KS;
    load_stage(0, first);
    cp_async_commit();

    // q's A fragments in 3xTF32 terms: k-step s8 = 2ks + p of 16-column
    // block ks takes columns 16ks + 4t + 2p (slot t) and + 1 (slot t + 4),
    // the K fragments' column order
#pragma unroll
    for (int e = 0; e < QE; ++e) {
      const int ks = warp + TC_WARPS * e;
      if (ks >= HD / 16) break;
      const float* x0 = reinterpret_cast<const float*>(&qv[e][0]);
      const float* x1 = reinterpret_cast<const float*>(&qv[e][1]);
#pragma unroll
      for (int p2 = 0; p2 < 2; ++p2) {
        uint32_t b0, s0, b1, s1, b2, s2, b3, s3;
        split_tf32(x0[2 * p2], b0, s0);
        split_tf32(x1[2 * p2], b1, s1);
        split_tf32(x0[2 * p2 + 1], b2, s2);
        split_tf32(x1[2 * p2 + 1], b3, s3);
        sq[(0 * T::KS8 + 2 * ks + p2) * 32 + lane] = make_uint4(b0, b1, b2, b3);
        sq[(1 * T::KS8 + 2 * ks + p2) * 32 + lane] = make_uint4(s0, s1, s2, s3);
      }
    }

    float acc[4][4];                                 // 4 n-tiles of 8 columns
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    for (int st = 0; st < nstage; ++st) {
      if (st + 1 < nstage) load_stage((st + 1) & 1, first + (st + 1) * T::KS);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
      const int cbase = first + st * T::KS + 16 * wg;       // this group's 16 keys
      if (cbase < end) {                                    // group-uniform
        const unsigned char* kst = stage + (st & 1) * T::STAGE_BYTES +
                                   static_cast<long>(16 * wg) * HD * T::EL;
        const unsigned char* vst = kst + static_cast<long>(T::KS) * HD * T::EL;
        // this warp's part of S = Q Kᵀ over its 32 columns (4 k-steps):
        // n-tile j is keys 8j..8j+7, this lane's K column key 8j + gid
        float s[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
          const int r = 8 * j + gid;
          const unsigned char* krow = kst + static_cast<long>(r) * HD * T::EL;
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int ks = 2 * h + kk;
            const float4 x = staged4(krow, 16 * ks + 4 * t4, r, TC());
            const float* xv = reinterpret_cast<const float*>(&x);
#pragma unroll
            for (int p2 = 0; p2 < 2; ++p2) {
              uint4 qa[2];
              qa[0] = sq[(0 * T::KS8 + 2 * ks + p2) * 32 + lane];
              qa[1] = nqt > 1 ? sq[(1 * T::KS8 + 2 * ks + p2) * 32 + lane]
                              : make_uint4(0, 0, 0, 0);
              uint32_t b0[2], b1[2];
              if constexpr (T::TERMS == 2) {
                split_tf32(xv[2 * p2], b0[0], b0[1]);
                split_tf32(xv[2 * p2 + 1], b1[0], b1[1]);
              } else {
                b0[0] = __float_as_uint(xv[2 * p2]);
                b1[0] = __float_as_uint(xv[2 * p2 + 1]);
                b0[1] = b1[1] = 0;
              }
              mma_terms(s[j], qa, nqt, b0, b1, T::TERMS);
            }
          }
        }
        // the group's parts of S, summed in part order by each of its warps
        float* xg = sx + wg * T::HSPLIT * 8 * 32;
#pragma unroll
        for (int e = 0; e < 8; ++e) xg[(h * 8 + e) * 32 + lane] = s[e / 4][e % 4];
        named_sync(1 + wg, 32 * T::HSPLIT);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float sum = 0.f;
#pragma unroll
          for (int hh = 0; hh < T::HSPLIT; ++hh) sum += xg[(hh * 8 + e) * 32 + lane];
          s[e / 4][e % 4] = sum;
        }
        // the online softmax on the fragments: this lane holds rows gid (c0,
        // c1) and gid + 8 (c2, c3) at keys 8j + 2t + {0, 1}
        float p[2][4];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float mx = m[rr];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool ok = cbase + 8 * j + 2 * t4 + e < end;
              const float v = apply_softcap(s[j][2 * rr + e] * scale, softcap);
              s[j][2 * rr + e] = ok ? v : NEG_INF;
              mx = fmaxf(mx, s[j][2 * rr + e]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float corr = __expf(m[rr] - mx);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool ok = cbase + 8 * j + 2 * t4 + e < end;
              const float pv = ok ? __expf(s[j][2 * rr + e] - mx) : 0.f;
              p[j][2 * rr + e] = pv;
              sum += pv;
            }
          l[rr] = l[rr] * corr + sum;
          m[rr] = mx;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            acc[n][2 * rr] *= corr;
            acc[n][2 * rr + 1] *= corr;
          }
        }
        // P·V a k-step of 8 keys at a time (keys 8j + 2t in slot t, 8j + 2t
        // + 1 in slot t + 4: P's A fragment is S's C fragment); n-tile r2 is
        // the output columns dbase + 4n + r2, this lane's B column n = gid
        const int e0 = dbase + 4 * gid;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint4 pa[2];
          {
            uint32_t b0, s0, b1, s1, b2, s2, b3, s3;
            split_tf32(p[j][0], b0, s0);
            split_tf32(p[j][2], b1, s1);
            split_tf32(p[j][1], b2, s2);
            split_tf32(p[j][3], b3, s3);
            pa[0] = make_uint4(b0, b1, b2, b3);
            pa[1] = make_uint4(s0, s1, s2, s3);
          }
          const int r0 = 8 * j + 2 * t4;
          const float4 v0 = staged4(vst + static_cast<long>(r0) * HD * T::EL, e0, r0, TC());
          const float4 v1 = staged4(vst + static_cast<long>(r0 + 1) * HD * T::EL, e0, r0 + 1,
                                    TC());
          const float* f0 = reinterpret_cast<const float*>(&v0);
          const float* f1 = reinterpret_cast<const float*>(&v1);
#pragma unroll
          for (int r2 = 0; r2 < 4; ++r2) {
            uint32_t b0[2], b1[2];
            if constexpr (T::TERMS == 2) {
              split_tf32(f0[r2], b0[0], b0[1]);
              split_tf32(f1[r2], b1[0], b1[1]);
            } else {
              b0[0] = __float_as_uint(f0[r2]);
              b1[0] = __float_as_uint(f1[r2]);
              b0[1] = b1[1] = 0;
            }
            mma_terms(acc[r2], pa, 2, b0, b1, T::TERMS);
          }
        }
      }
      __syncthreads();                // the buffers are refilled one stage on
    }

    // a row's sum over the quad's lanes; the groups' states into shared
    // memory (the stage buffers are free)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int g = gid + 8 * rr;
      if (g >= G) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = dbase + 4 * (2 * t4 + e);
        if (d < hd)
          store4(s_acc + (wg * G + g) * hd + d,
                 make_float4(acc[0][2 * rr + e], acc[1][2 * rr + e], acc[2][2 * rr + e],
                             acc[3][2 * rr + e]));
      }
      if (t4 == 0 && h == 0) {
        s_m[wg * G + g] = m[rr];
        s_l[wg * G + g] = l[rr];
      }
    }
    __syncthreads();
  }
  finish_cluster<TC, T::NG, TC_THREADS>(s_acc, s_m, s_l, live, o, b, hk, Hkv, G, hd, split,
                                        nsplit, sp);
}

struct Args {
  const void* q;
  int q_bf16;
  const void *k, *v;
  const int* clen;
  void* o;
  float* part;
  int* counters;
  int B, S, Hq, Hkv, hd, G, rows, window;
  float scale, softcap;
  cudaStream_t stream;
};

template <typename TC, int HD, int GT>
cudaError_t launch(const Args& a) {
  const int nsplit = max(1, (a.S + a.rows - 1) / a.rows);
  if (nsplit > MAX_SPLITS) return cudaErrorInvalidValue;
  const TC* k = static_cast<const TC*>(a.k);
  const TC* v = static_cast<const TC*>(a.v);
  TC* o = static_cast<TC*>(a.o);
  const dim3 grid(a.Hkv, a.B, nsplit);       // split slowest
  cudaError_t err;
  if constexpr (GT == 16) {
    // a cluster per (kv head, b): its splits
    if (a.hd % 16 != 0) return cudaErrorInvalidValue;
    auto kernel = decode_split_tc_kernel<TC, HD>;
    const size_t smem = TcShape<TC, HD>::SMEM;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess && nsplit > 8)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = nsplit;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(TC_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = a.stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a.q, a.q_bf16, k, v, a.clen, o, a.S, a.Hq, a.Hkv,
                             a.hd, a.G, a.rows, nsplit, a.window, a.scale, a.softcap);
    if (err != cudaSuccess) return err;
  } else {
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(WARPS) * a.G * a.hd + 2 * WARPS * a.G);
    auto kernel = decode_split_kernel<TC, HD, GT>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, smem, a.stream>>>(a.q, a.q_bf16, k, v, a.clen, a.part, a.counters,
                                              o, a.S, a.Hq, a.Hkv, a.hd, a.G, a.rows, nsplit,
                                              a.window, a.scale, a.softcap);
  }
  return cudaGetLastError();
}

template <typename TC, int HD>
cudaError_t dispatch_groups(const Args& a) {
  if (a.G <= 1) return launch<TC, HD, 1>(a);
  if (a.G <= 2) return launch<TC, HD, 2>(a);
  if (a.G <= 4) return launch<TC, HD, 4>(a);
  if (a.G <= 8) return launch<TC, HD, 8>(a);
  if (a.G <= 16) return launch<TC, HD, 16>(a);
  return cudaErrorInvalidValue;
}

template <typename TC>
cudaError_t dispatch_hd(const Args& a) {
  if (a.hd <= 64) return dispatch_groups<TC, 64>(a);
  if (a.hd <= 128) return dispatch_groups<TC, 128>(a);
  if (a.hd <= 256) return dispatch_groups<TC, 256>(a);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// q_dtype / c_dtype: 0 = float32, 1 = bfloat16. cache_len: (B,) int32 on
// the device. nsplit = ceil(S / split_rows) <= 16. At G <= 8: scratch, B *
// Hkv * nsplit * slot floats (slot = G * hd + 2G rounded up to a multiple
// of 4), and counters, B * Hkv int32, all 0 before the launch and all 0
// again after it; at G > 8 neither is read (null is fine). window <= 0
// means none; softcap <= 0 means none. One launch on the stream; returns
// its error or cudaGetLastError() after it.
extern "C" int decode_forward(const void* q, const void* k, const void* v,
                              const void* cache_len, void* o, void* scratch, void* counters,
                              int q_dtype, int c_dtype, int B, int S, int Hq, int Hkv, int hd,
                              int split_rows, int window, float scale, float softcap,
                              void* stream) {
  if (hd % 4 != 0 || Hkv <= 0 || Hq % Hkv != 0 || q_dtype < 0 || q_dtype > 1 ||
      split_rows <= 0 || B > 65535 || Hkv > 65535)
    return cudaErrorInvalidValue;
  const repro::Args a{q, q_dtype, k, v, static_cast<const int*>(cache_len), o,
                      static_cast<float*>(scratch), static_cast<int*>(counters), B, S, Hq,
                      Hkv, hd, Hq / Hkv, split_rows, window, scale, softcap,
                      static_cast<cudaStream_t>(stream)};
  if (c_dtype == 0) return repro::dispatch_hd<float>(a);
  if (c_dtype == 1) return repro::dispatch_hd<__nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}
