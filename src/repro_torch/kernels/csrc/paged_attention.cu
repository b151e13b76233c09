// Paged decode attention for NVIDIA Hopper (sm_90a): the decode kernel.
//
// Replaces: src/repro/kernels/paged_attention.py, paged_attention_kernel /
// _paged_kernel (Pallas, TPU).  Same function: one query token per
// sequence attends over KV pages found through block_table[b, j], masked to
// lengths[b]; GQA with q viewed (Hkv, G, D); online softmax in f32 with
// scale 1/sqrt(D); pages past the length are never read; length 0 -> zeros.
// Layouts: q/o (B, Hq, D), k/v_pages (P, page, Hkv, D), block_table
// (B, per_seq) int32, lengths (B,) int32, all contiguous; bf16 or f32 data;
// D a multiple of 8 and at most 128; G = Hq / Hkv at most 16.
//
// What bounds it on an H100: decode attention does 2 FLOP per byte or
// less, so it is bandwidth-bound.  Each cached token costs
// Hkv * D * 2 B * 2 (K and V) = 4096 B per layer for qwen3-0.6b in bf16;
// the bound is the bytes of the live tokens over 3.35 TB/s.  Reaching it
// takes ~25 KB in flight per SM (3.35 TB/s x ~1 us of latency / 132 SMs)
// and every SM busy, at 8 sequences of a few hundred tokens.  A CTA that
// walks its tokens tile by tile, with barriers and a softmax step per
// tile, is bound instead by that chain's latency.
//
// What this design does about it:
// - The grid is (KV head, sequence, split).  A split is a fixed run of
//   `split` tokens, and the number of splits comes from the cache's
//   capacity (per_seq * page), never from `lengths`, so the host reads
//   nothing back.  A split at or past its sequence's length leaves at once
//   (split 0 of a sequence of length 0 writes its zeros); split-major
//   order launches those last.
// - A split is read in chunks of 128 tokens in bf16 (64 in f32, 32 KB of
//   K at D = 128): each token's row offset is looked up in the block table
//   once, then every page tile of the chunk is in flight at once, K as one
//   cp.async group and V as another (16 bytes a copy).  The scores of the
//   whole chunk (8 lanes per token, the G query heads of the group sharing
//   each K row) are computed as soon as K lands, while V still arrives;
//   then one softmax step per chunk (a warp per head, online across
//   chunks) and the values (two or more threads per column of V).  Four
//   barriers per chunk; the arithmetic is f32.
// - A sequence that fits one split is written out by that split.  Else
//   each live split writes its partial (m, l and the unnormalised
//   acc[G][D]) to scratch, then counts itself in on a per-(sequence, KV
//   head) counter; the last to arrive merges the live partials, writes the
//   output and sets its counter back to 0, so the combine needs no second
//   launch and the counters stay zeroed between launches.
// - Optionally (lse non-null) the launch also writes each head's
//   log-sum-exp of its scaled scores, lse (B, Hq) f32 (-inf at length 0),
//   from the m and l it already holds, so that slices of one sequence
//   attended apart (a sequence-sharded cache) merge exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int LPT = 8;             // lanes per token in the score product
constexpr int MAX_G = 16;          // query heads per KV head
constexpr int PV = 8;              // tokens per step of the value loop
constexpr int CHUNK_BYTES = 32768;  // K (or V) of one chunk at D = 128

// tokens of one chunk: 128 in bf16, 64 in f32 (page tiles of 16: 8 or 4)
template <typename T>
__host__ __device__ constexpr int chunk_tokens() {
  return CHUNK_BYTES / (128 * int(sizeof(T)));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of shared memory as f32: 4 floats or 8 bf16
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 16 bytes global -> shared, asynchronous
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory: a region used first for the chunk's K and V rows
// [2][CT][D] of T, then for the sum over token parts [R][G][D] and the
// merge's m and l [n_splits][G][2] (f32); after it, the chunk's row
// offsets [CT] (size_t), then f32 qs [G][D], ps [G][CT] and m, l, alpha,
// 1/L [G] each.
template <typename T>
__host__ __device__ inline size_t region_bytes(int G, int D, int n_splits) {
  size_t n = size_t(2) * chunk_tokens<T>() * D * sizeof(T);
  const size_t red = size_t(THREADS / D) * G * D * sizeof(float);
  const size_t w = size_t(n_splits) * G * 2 * sizeof(float);
  n = n > red ? n : red;
  n = n > w ? n : w;
  return (n + 15) & ~size_t(15);
}

template <typename T>
inline size_t smem_bytes(int G, int D, int n_splits) {
  constexpr int CT = chunk_tokens<T>();
  return region_bytes<T>(G, D, n_splits) + sizeof(size_t) * CT +
         sizeof(float) * (size_t(G) * D + size_t(G) * CT + 4 * size_t(G));
}

// three CTAs per SM (80 registers a thread): more splits in flight at once
// beat more registers per thread at both serving shapes
template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ table,
                   const int* __restrict__ lengths, T* __restrict__ o,
                   float* __restrict__ part, int* __restrict__ counters,
                   float* __restrict__ lse, int Hq, int Hkv, int D, int page,
                   int per_seq, int split, float sm_scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int MAXC = (128 / VEC + LPT - 1) / LPT;  // chunks per lane
  constexpr int CT = chunk_tokens<T>();
  constexpr int TPL = CT / 32;  // tokens per lane in the softmax
  extern __shared__ float4 smem4[];
  __shared__ int s_last;
  const int G = Hq / Hkv;
  const int n_splits = gridDim.z;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  T* ks = reinterpret_cast<T*>(smem);   // [CT][D] the chunk's keys
  T* vs = ks + CT * D;                  // [CT][D] and values
  float* region = reinterpret_cast<float*>(smem);
  size_t* rows = reinterpret_cast<size_t*>(smem +
                                           region_bytes<T>(G, D, n_splits));
  float* qs = reinterpret_cast<float*>(rows + CT);
  float* ps = qs + G * D;      // [G][CT] scores, then probabilities
  float* m_s = ps + G * CT;    // [G] running max
  float* l_s = m_s + G;        // [G] running sum
  float* a_s = l_s + G;        // [G] this chunk's rescale factor
  float* inv_s = a_s + G;      // [G] 1 / L of the merge

  const int len = max(0, min(lengths[b], per_seq * page));
  const int n_live = (len + split - 1) / split;  // splits holding tokens
  T* og = o + (size_t(b) * Hq + size_t(hk) * G) * D;
  float* lse_g = lse ? lse + size_t(b) * Hq + size_t(hk) * G : nullptr;
  if (len == 0) {  // no token: split 0 writes zeros
    if (sp == 0) {
      for (int e = tid; e < G * D; e += THREADS) store(&og[e], 0.f);
      if (lse_g)
        for (int g = tid; g < G; g += THREADS) lse_g[g] = -INFINITY;
    }
    return;
  }
  if (sp >= n_live) return;  // past the length: nothing to read or merge
  const int t_begin = sp * split;
  const int t_end = min(t_begin + split, len);
  const size_t stride = size_t(G) * (D + 2);  // acc[D], m, l per head
  float* mine = part + (size_t(b * Hkv + hk) * n_splits + sp) * stride;

  const int* tbl = table + size_t(b) * per_seq;
  const size_t tok_stride = size_t(Hkv) * D;  // one token's row
  const T* kh = kp + size_t(hk) * D;
  const T* vh = vp + size_t(hk) * D;
  const int cpr = D / VEC;  // 16-byte chunks per row
  const T* qg = q + (size_t(b) * Hq + size_t(hk) * G) * D;
  for (int e = tid; e < G * D; e += THREADS) qs[e] = to_f32(qg[e]);
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  // value product: thread (vp_part, vd) sums tokens vp_part, + R, ...
  const int R = THREADS / D;  // >= 2 as D <= 128
  const int vp_part = tid / D;
  const int vd = tid % D;
  const bool v_live = vp_part < R;
  // score product: per step, warp w takes 4 tokens, LPT lanes each
  const int j = lane % LPT;
  float acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;

  for (int c0 = t_begin; c0 < t_end; c0 += CT) {
    const int n_tok = min(CT, t_end - c0);
    for (int r = tid; r < n_tok; r += THREADS) {
      const int t = c0 + r;
      rows[r] = (size_t(tbl[t / page]) * page + t % page) * tok_stride;
    }
    __syncthreads();  // rows ready; the last chunk's K, V, ps are read
    // every page tile of the chunk in flight at once: K as one group,
    // then V as another, 16 bytes a copy
    for (int c = tid; c < n_tok * cpr; c += THREADS) {
      const int r = c / cpr;
      const int off = (c - r * cpr) * VEC;
      cp_async16(ks + r * D + off, kh + rows[r] + off);
    }
    cp_async_commit();
    for (int c = tid; c < n_tok * cpr; c += THREADS) {
      const int r = c / cpr;
      const int off = (c - r * cpr) * VEC;
      cp_async16(vs + r * D + off, vh + rows[r] + off);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's keys
    __syncthreads();     // everyone's keys

    // scores; the values keep arriving meanwhile
    // two tokens per lane group, 32 tokens apart: two independent chains
    for (int t8 = warp * 4; t8 < n_tok; t8 += NWARP * 8) {
      int tk[2];
      bool live[2];
      float kv[2][MAXC][VEC];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        tk[u] = t8 + u * NWARP * 4 + lane / LPT;
        live[u] = tk[u] < n_tok;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          const int ch = j + c * LPT;
          if (live[u] && ch < cpr) {
            load16(ks + tk[u] * D + ch * VEC, kv[u][c]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) kv[u][c][e] = 0.f;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g >= G) break;
        float sc[2] = {0.f, 0.f};
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          const int ch = j + c * LPT;
          if (ch < cpr) {
            const float* qd = qs + g * D + ch * VEC;
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float qe = qd[e];
              sc[0] = fmaf(qe, kv[0][c][e], sc[0]);
              sc[1] = fmaf(qe, kv[1][c][e], sc[1]);
            }
          }
        }
#pragma unroll
        for (int off = LPT / 2; off > 0; off >>= 1) {
          sc[0] += __shfl_xor_sync(0xffffffffu, sc[0], off);
          sc[1] += __shfl_xor_sync(0xffffffffu, sc[1], off);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (live[u] && j == 0) ps[g * CT + tk[u]] = sc[u] * sm_scale;
      }
    }
    __syncthreads();

    // softmax over the chunk, online across chunks: a warp per head
    for (int g = warp; g < G; g += NWARP) {
      float sv[TPL];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < TPL; ++i) {
        const int tt = lane + 32 * i;
        sv[i] = tt < n_tok ? ps[g * CT + tt] : -INFINITY;
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);  // finite: the chunk has tokens
      const float alpha = expf(m_old - m_new);  // 0 on the first chunk
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < TPL; ++i) {
        const int tt = lane + 32 * i;
        const float p = expf(sv[i] - m_new);
        if (tt < n_tok) ps[g * CT + tt] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (lane == 0) {
        l_s[g] = l_s[g] * alpha + rs;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    cp_async_wait<0>();  // this thread's values
    __syncthreads();     // everyone's values; the probabilities

    // values: this thread's tokens for every query head of the group, 8
    // at a time so that their loads overlap
    if (v_live) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g] *= a_s[g];
      for (int t0 = vp_part; t0 < n_tok; t0 += PV * R) {
        float v[PV];
#pragma unroll
        for (int i = 0; i < PV; ++i) {
          const int tt = t0 + i * R;
          v[i] = tt < n_tok ? to_f32(vs[tt * D + vd]) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
            float a = acc[g];
#pragma unroll
            for (int i = 0; i < PV; ++i) {
              const int tt = t0 + i * R;
              a = fmaf(tt < n_tok ? ps[g * CT + tt] : 0.f, v[i], a);
            }
            acc[g] = a;
          }
        }
      }
    }
  }
  __syncthreads();  // the chunk buffers become the sum over token parts

  if (v_live) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) region[(vp_part * G + g) * D + vd] = acc[g];
  }
  __syncthreads();
  // a sequence within one split needs no merge: write the output
  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D;
    float sum = 0.f;
    for (int r = 0; r < R; ++r) sum += region[r * G * D + e];
    if (n_live == 1)
      store(&og[e], sum / l_s[g]);
    else
      mine[g * (D + 2) + (e - g * D)] = sum;
  }
  if (n_live == 1) {
    if (lse_g)
      for (int g = tid; g < G; g += THREADS) lse_g[g] = m_s[g] + logf(l_s[g]);
    return;
  }
  for (int g = tid; g < G; g += THREADS) {
    mine[g * (D + 2) + D] = m_s[g];
    mine[g * (D + 2) + D + 1] = l_s[g];
  }

  // count in; the last live split of this (sequence, KV head) merges
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(&counters[b * Hkv + hk], 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (tid == 0) counters[b * Hkv + hk] = 0;

  // every split's m and l at once, then each head's max, sum and weights
  const float* parts = part + size_t(b * Hkv + hk) * n_splits * stride;
  float* ml = region;  // [n_live][G][2]: m then l; m becomes the weight
  for (int e = tid; e < n_live * G; e += THREADS) {
    const int sp_e = e / G;
    const float* src = parts + sp_e * stride + (e - sp_e * G) * (D + 2) + D;
    ml[2 * e] = __ldcg(src);
    ml[2 * e + 1] = __ldcg(src + 1);
  }
  __syncthreads();
  for (int g = tid; g < G; g += THREADS) {
    float M = -INFINITY;
    for (int s = 0; s < n_live; ++s) M = fmaxf(M, ml[2 * (s * G + g)]);
    float L = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float wt = expf(ml[2 * (s * G + g)] - M);
      ml[2 * (s * G + g)] = wt;
      L += ml[2 * (s * G + g) + 1] * wt;
    }
    inv_s[g] = 1.f / L;  // every live split holds a token: L > 0
    if (lse_g) lse_g[g] = M + logf(L);
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D;
    const float* src = parts + g * (D + 2) + (e - g * D);
    float sum = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_live; ++s)
      sum += ml[2 * (s * G + g)] * __ldcg(src + s * stride);
    store(&og[e], sum * inv_s[g]);
  }
}

// The dynamic shared memory each kernel (f32, bf16) was opened to on each
// device: setting the attribute on every launch is a driver call per
// launch, so it is raised only when a launch needs more.
constexpr int MAX_DEVICES = 64;
size_t smem_opened[2][MAX_DEVICES];

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* table,
           const void* lengths, void* o, void* partials, void* counters,
           void* lse, int B, int Hq, int Hkv, int D, int page, int per_seq,
           int split, int n_splits, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(Hq / Hkv, D, n_splits);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= MAX_DEVICES) return int(cudaErrorInvalidDevice);
  // 64 KB of K and V per chunk: above the 48 KB default
  size_t& opened = smem_opened[sizeof(T) == 2][dev];
  if (smem > opened) {
    err = cudaFuncSetAttribute(paged_split_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
    opened = smem;
  }
  // split-major: every sequence's first splits launch first, the splits
  // past most lengths (which leave at once) last
  const dim3 grid(Hkv, B, n_splits);
  paged_split_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(o),
      static_cast<float*>(partials), static_cast<int*>(counters),
      static_cast<float*>(lse), Hq, Hkv, D, page, per_seq, split,
      1.f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry: dtype 0 = float32, 1 = bfloat16.  partials: f32 scratch
// of B * Hkv * n_splits * G * (D + 2); counters: B * Hkv int32, zero on
// entry and left zero (one launch at a time may use them); n_splits =
// ceil(per_seq * page / split); lse: null, or (B, Hq) f32 for each head's
// log-sum-exp.  Returns the CUDA error code of the launch (0 = launched).
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* block_table,
                                     const void* lengths, void* o,
                                     void* partials, void* counters,
                                     void* lse, int B,
                                     int Hq, int Hkv, int D, int page,
                                     int per_seq, int split, int n_splits,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_table, lengths,
                                 o, partials, counters, lse, B, Hq, Hkv, D,
                                 page, per_seq, split, n_splits, s);
  return launch<float>(q, k_pages, v_pages, block_table, lengths, o,
                       partials, counters, lse, B, Hq, Hkv, D, page, per_seq,
                       split, n_splits, s);
}
