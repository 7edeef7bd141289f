// Gossip-round kernels for Hopper (sm_90a), with a plain C interface.
//
// Five kernels carry the round's select, merge and flush passes.  They
// compute what the Pallas kernels of serf_tpu/ops/round_kernels.py
// compute, bit for bit:
//
//   select_packets       <- _make_select_kernel (round_kernels.py:263)
//   merge_incoming       <- _make_merge_kernel (round_kernels.py:346)
//   fused_select_cached  <- _make_fused_select_kernel (round_kernels.py:426)
//   fused_merge          <- _make_fused_merge_kernel (round_kernels.py:474)
//   fused_flush          <- _make_fused_flush_kernel (round_kernels.py:610)
//
// Layout.  known / incoming / sendable / overlay / packets are u32[N, W]
// words (W = K / 32); stamps are u8[N, C], C = K / 2 nibble-packed (two
// 4-bit learn stamps per byte) or C = K unpacked.  Fact 2c+p of packed
// byte c is bit 2*(c%16)+p of word c/16, so word w of a row is exactly
// packed stamp bytes 16w..16w+15 (unpacked: bytes 32w..32w+31, fact j =
// bit j).
//
// Bounds.  Every kernel is one streaming pass with no reuse.  The cached
// select moves 25 bytes per word for two ANDs: HBM bounds it (3.35 TB/s
// on an H100 SXM).  The four stamp-plane kernels spend 5-11 integer
// operations per fact (nibble extract, wrapping subtract, compare,
// weave), a few hundred per 32-fact word against 44-97 bytes moved, so
// the SMs' 32-bit integer issue rate may bound them before HBM does.
//
// Design.  One thread owns one (row, word): it reads its word(s), the
// row's alive byte and the word's 16 (or 32) stamp bytes with one (or
// two) 16-byte loads, builds the word's 32 nibbles and age-predicate
// bits in registers (restamp_word, shared by the three stamp-writing
// kernels) and writes one word plus the 16/32 new stamp bytes with
// 16-byte stores.  Neighbouring threads touch neighbouring words and
// neighbouring 16-byte stamp chunks, so every load and store is
// coalesced.  The TPU kernels' per-grid-step learn flag becomes one count
// per CUDA block (blocks run in no order; the caller only asks whether
// any count is non-zero).  Kernels never allocate and never synchronise;
// the caller passes outputs allocated with torch.empty and the current
// stream.
//
// Round scalars are read from device memory (a 0-d int32 tensor), and
// each kernel derives the stamp quarters it needs, so the host never
// waits on the device to launch a round.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // ops/round_kernels.py THREADS
constexpr int kStampShift = 2;   // dissemination.STAMP_SHIFT
constexpr int kAgePinQ = 8;      // dissemination.AGE_PIN_Q

// the 4-bit stamp value of a round: its quarter index mod 16
__device__ __forceinline__ int quarter(int32_t round) {
  return (round >> kStampShift) & 0xF;
}

// derived q-age below the transmit window (wrapping 4-bit subtraction)
__device__ __forceinline__ uint32_t young(int rq, int nib, int limit_q) {
  return ((rq - nib) & 0xF) < limit_q ? 1u : 0u;
}

// re-pin a wrap-stale stamp at q-age kAgePinQ (dissemination.clamp_nibbles)
__device__ __forceinline__ int clamped(int rq, int nib) {
  return ((rq - nib) & 0xF) > kAgePinQ ? ((rq - kAgePinQ) & 0xF) : nib;
}

// one fact's new stamp: clamp at rq, then a pending overlay bit writes
// the cohort quarter rq_prev, then a fresh learn writes rq (and wins)
__device__ __forceinline__ int restamped(uint32_t fresh, uint32_t overlay,
                                         int rq, int rq_prev, int nib) {
  return (fresh & 1u) ? rq : ((overlay & 1u) ? rq_prev : clamped(rq, nib));
}

__device__ __forceinline__ int byte_of(const uint32_t* q, int j) {
  return (q[j >> 2] >> (8 * (j & 3))) & 0xFF;
}

// the word's 32 age bits from its 16 packed stamp bytes
__device__ __forceinline__ uint32_t packed_pred(uint4 v, int rq,
                                                int limit_q) {
  const uint32_t q[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int b = byte_of(q, j);
    bits |= young(rq, b & 0xF, limit_q) << (2 * j);
    bits |= young(rq, b >> 4, limit_q) << (2 * j + 1);
  }
  return bits;
}

// the word's 32 age bits from its 32 unpacked stamp bytes
__device__ __forceinline__ uint32_t unpacked_pred(uint4 a, uint4 b, int rq,
                                                  int limit_q) {
  const uint32_t q[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) bits |= young(rq, byte_of(q, j), limit_q) << j;
  return bits;
}

// The stamp pass of one word, shared by the merge and flush kernels:
// read the word's stamp bytes at `in`, restamp every fact (restamped),
// write the bytes to `out`, and return (kWithCache) the age bits of the
// final nibbles — the sendable cache's predicate — while they are still
// in registers.  The merges pass overlay = 0, which the compiler folds.
template <bool kPacked, bool kWithCache>
__device__ __forceinline__ uint32_t restamp_word(const uint8_t* in,
                                                 uint8_t* out, uint32_t fresh,
                                                 uint32_t overlay, int rq,
                                                 int rq_prev, int limit_q) {
  uint32_t ok = 0u;
  if (kPacked) {
    const uint4 v = *reinterpret_cast<const uint4*>(in);
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int b = byte_of(q, j);
      const int lo = restamped(fresh >> (2 * j), overlay >> (2 * j), rq,
                               rq_prev, b & 0xF);
      const int hi = restamped(fresh >> (2 * j + 1), overlay >> (2 * j + 1),
                               rq, rq_prev, b >> 4);
      o[j >> 2] |= uint32_t(lo | (hi << 4)) << (8 * (j & 3));
      if (kWithCache) {
        ok |= young(rq, lo, limit_q) << (2 * j);
        ok |= young(rq, hi, limit_q) << (2 * j + 1);
      }
    }
    *reinterpret_cast<uint4*>(out) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
    const uint4* p = reinterpret_cast<const uint4*>(in);
    const uint4 a = p[0], c = p[1];
    const uint32_t q[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
    uint32_t o[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int nib =
          restamped(fresh >> j, overlay >> j, rq, rq_prev, byte_of(q, j));
      o[j >> 2] |= uint32_t(nib & 0xFF) << (8 * (j & 3));
      if (kWithCache) ok |= young(rq, nib, limit_q) << j;
    }
    uint4* d = reinterpret_cast<uint4*>(out);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
  return ok;
}

// byte offset of word w's stamp chunk in row `row`
template <bool kPacked>
__device__ __forceinline__ int64_t chunk_of(int64_t row, int w, int cols) {
  return row * cols + (kPacked ? 16 : 32) * w;
}

// packets = known & age_ok & alive — a read-only pass over the stamp plane
template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
select_packets_kernel(const uint8_t* __restrict__ stamp,
                      const uint32_t* __restrict__ known,
                      const uint8_t* __restrict__ alive,
                      const int32_t* __restrict__ round,
                      uint32_t* __restrict__ packets, int64_t total,
                      int words, int cols, int limit_q) {
  const int64_t t = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t row = t / words;
  const int w = int(t - row * words);
  if (!alive[row]) {
    packets[t] = 0u;
    return;
  }
  const int rq = quarter(*round);
  const uint8_t* s = stamp + chunk_of<kPacked>(row, w, cols);
  uint32_t age_ok;
  if (kPacked) {
    age_ok = packed_pred(*reinterpret_cast<const uint4*>(s), rq, limit_q);
  } else {
    const uint4* p = reinterpret_cast<const uint4*>(s);
    age_ok = unpacked_pred(p[0], p[1], rq, limit_q);
  }
  packets[t] = known[t] & age_ok;
}

// packets = sendable & known & alive — the word plane only, no stamp read
__global__ void __launch_bounds__(kThreads)
fused_select_kernel(const uint32_t* __restrict__ sendable,
                    const uint32_t* __restrict__ known,
                    const uint8_t* __restrict__ alive,
                    uint32_t* __restrict__ packets, int64_t total,
                    int words) {
  const int64_t t = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  packets[t] = alive[t / words] ? (sendable[t] & known[t]) : 0u;
}

// the standalone merge: learn, clamp and stamp the learned nibbles with
// the next round's quarter — no cache, no learn flags (the caller asks
// whether known changed)
template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
merge_incoming_kernel(const uint32_t* __restrict__ known,
                      const uint32_t* __restrict__ incoming,
                      const uint8_t* __restrict__ alive,
                      const uint8_t* __restrict__ stamp,
                      const int32_t* __restrict__ next_round,
                      uint32_t* __restrict__ known_out,
                      uint8_t* __restrict__ stamp_out, int64_t total,
                      int words, int cols) {
  const int64_t t = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t row = t / words;
  const int w = int(t - row * words);
  const uint32_t k0 = known[t];
  const uint32_t fresh = incoming[t] & ~k0 & (alive[row] ? 0xFFFFFFFFu : 0u);
  known_out[t] = k0 | fresh;
  const int rq = quarter(*next_round);
  const int64_t off = chunk_of<kPacked>(row, w, cols);
  restamp_word<kPacked, false>(stamp + off, stamp_out + off, fresh, 0u, rq,
                               rq, 0);
}

// learn, clamp, stamp the learned nibbles with the next round's quarter,
// and (kWithCache) recompute sendable' = known' & (q-age' < limit_q) from
// the new nibbles while they are still in registers
template <bool kPacked, bool kWithCache>
__global__ void __launch_bounds__(kThreads)
fused_merge_kernel(const uint32_t* __restrict__ known,
                   const uint32_t* __restrict__ incoming,
                   const uint8_t* __restrict__ alive,
                   const uint8_t* __restrict__ stamp,
                   const int32_t* __restrict__ next_round,
                   uint32_t* __restrict__ known_out,
                   uint8_t* __restrict__ stamp_out,
                   uint32_t* __restrict__ sendable_out,
                   int32_t* __restrict__ flags, int64_t total, int words,
                   int cols, int limit_q) {
  const int64_t t = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t fresh = 0u;
  if (t < total) {
    const int64_t row = t / words;
    const int w = int(t - row * words);
    const uint32_t k0 = known[t];
    fresh = incoming[t] & ~k0 & (alive[row] ? 0xFFFFFFFFu : 0u);
    const uint32_t k1 = k0 | fresh;
    known_out[t] = k1;
    const int rq = quarter(*next_round);
    const int64_t off = chunk_of<kPacked>(row, w, cols);
    const uint32_t ok = restamp_word<kPacked, kWithCache>(
        stamp + off, stamp_out + off, fresh, 0u, rq, rq, limit_q);
    if (kWithCache) sendable_out[t] = k1 & ok;
  }
  // every thread of the block reaches this barrier (no early return)
  const int learned = __syncthreads_count(fresh != 0u);
  if (threadIdx.x == 0) flags[blockIdx.x] = learned;
}

// the deferred flavor's cohort flush: clamp at the flush round's quarter,
// pending overlay cells -> the cohort quarter, this merge's learns -> the
// flush round's quarter (a fresh learn wins over an overlay bit), then
// (kWithCache) the sendable cache from the final nibbles.  known2 is the
// post-merge known plane, read only for the cache.
template <bool kPacked, bool kWithCache>
__global__ void __launch_bounds__(kThreads)
fused_flush_kernel(const uint32_t* __restrict__ known2,
                   const uint32_t* __restrict__ new_words,
                   const uint32_t* __restrict__ overlay,
                   const uint8_t* __restrict__ stamp,
                   const int32_t* __restrict__ next_round,
                   uint8_t* __restrict__ stamp_out,
                   uint32_t* __restrict__ sendable_out, int64_t total,
                   int words, int cols, int limit_q) {
  const int64_t t = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t row = t / words;
  const int w = int(t - row * words);
  const int32_t nr = *next_round;
  const int64_t off = chunk_of<kPacked>(row, w, cols);
  const uint32_t ok = restamp_word<kPacked, kWithCache>(
      stamp + off, stamp_out + off, new_words[t], overlay[t], quarter(nr),
      quarter(nr - 1), limit_q);
  if (kWithCache) sendable_out[t] = known2[t] & ok;
}

inline unsigned blocks_for(int64_t total) {
  return unsigned((total + kThreads - 1) / kThreads);
}

// calls f(kPacked, kWithCache) with the runtime flags as compile-time
// std::bool_constant values, so each launch picks its template instance
template <typename F>
void dispatch(int packed, int with_cache, F&& f) {
  using T = std::true_type;
  using N = std::false_type;
  if (packed && with_cache) {
    f(T{}, T{});
  } else if (packed) {
    f(T{}, N{});
  } else if (with_cache) {
    f(N{}, T{});
  } else {
    f(N{}, N{});
  }
}

template <typename P>
const P* in(const void* p) {
  return static_cast<const P*>(p);
}

template <typename P>
P* out(void* p) {
  return static_cast<P*>(p);
}

}  // namespace

extern "C" {

const char* serf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int serf_select_packets(const void* stamp, const void* known,
                        const void* alive, const void* round, void* packets,
                        int64_t n, int words, int cols, int limit_q,
                        int packed, void* stream) {
  const int64_t total = n * words;
  if (total == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  dispatch(packed, 0, [&](auto p, auto) {
    select_packets_kernel<decltype(p)::value>
        <<<blocks_for(total), kThreads, 0, s>>>(
            in<uint8_t>(stamp), in<uint32_t>(known), in<uint8_t>(alive),
            in<int32_t>(round), out<uint32_t>(packets), total, words, cols,
            limit_q);
  });
  return static_cast<int>(cudaGetLastError());
}

int serf_fused_select_cached(const void* sendable, const void* known,
                             const void* alive, void* packets, int64_t n,
                             int words, void* stream) {
  const int64_t total = n * words;
  if (total == 0) return 0;
  fused_select_kernel<<<blocks_for(total), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      in<uint32_t>(sendable), in<uint32_t>(known), in<uint8_t>(alive),
      out<uint32_t>(packets), total, words);
  return static_cast<int>(cudaGetLastError());
}

int serf_merge_incoming(const void* known, const void* incoming,
                        const void* alive, const void* stamp,
                        const void* next_round, void* known_out,
                        void* stamp_out, int64_t n, int words, int cols,
                        int packed, void* stream) {
  const int64_t total = n * words;
  if (total == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  dispatch(packed, 0, [&](auto p, auto) {
    merge_incoming_kernel<decltype(p)::value>
        <<<blocks_for(total), kThreads, 0, s>>>(
            in<uint32_t>(known), in<uint32_t>(incoming), in<uint8_t>(alive),
            in<uint8_t>(stamp), in<int32_t>(next_round),
            out<uint32_t>(known_out), out<uint8_t>(stamp_out), total, words,
            cols);
  });
  return static_cast<int>(cudaGetLastError());
}

int serf_fused_merge(const void* known, const void* incoming,
                     const void* alive, const void* stamp,
                     const void* next_round, void* known_out,
                     void* stamp_out, void* sendable_out, void* flags,
                     int64_t n, int words, int cols, int limit_q, int packed,
                     int with_cache, void* stream) {
  const int64_t total = n * words;
  if (total == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  dispatch(packed, with_cache, [&](auto p, auto c) {
    fused_merge_kernel<decltype(p)::value, decltype(c)::value>
        <<<blocks_for(total), kThreads, 0, s>>>(
            in<uint32_t>(known), in<uint32_t>(incoming), in<uint8_t>(alive),
            in<uint8_t>(stamp), in<int32_t>(next_round),
            out<uint32_t>(known_out), out<uint8_t>(stamp_out),
            out<uint32_t>(sendable_out), out<int32_t>(flags), total, words,
            cols, limit_q);
  });
  return static_cast<int>(cudaGetLastError());
}

int serf_fused_flush(const void* known2, const void* new_words,
                     const void* overlay, const void* stamp,
                     const void* next_round, void* stamp_out,
                     void* sendable_out, int64_t n, int words, int cols,
                     int limit_q, int packed, int with_cache, void* stream) {
  const int64_t total = n * words;
  if (total == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  dispatch(packed, with_cache, [&](auto p, auto c) {
    fused_flush_kernel<decltype(p)::value, decltype(c)::value>
        <<<blocks_for(total), kThreads, 0, s>>>(
            in<uint32_t>(known2), in<uint32_t>(new_words),
            in<uint32_t>(overlay), in<uint8_t>(stamp),
            in<int32_t>(next_round), out<uint8_t>(stamp_out),
            out<uint32_t>(sendable_out), total, words, cols, limit_q);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
