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
// bit j), and word t of the plane is the t-th 16-byte (32-byte) chunk.
//
// Bounds.  Every kernel is one streaming pass with no reuse and no matrix
// product, so TMA and wgmma have nothing to offer: the Hopper design is a
// plain pass with 16-byte loads, neighbouring threads on neighbouring
// chunks, and enough bytes in flight, and HBM (3.35 TB/s on an H100 SXM)
// is the bound to reach.  What can stand in the way is instruction
// issue: 132 SMs x 64 lanes x 1.98 GHz ~ 16.7 T ops/s on the 32-bit
// integer pipe, and twice that for all instructions together (four warp
// instructions per SM a clock).  The cached select moves 25 bytes per
// word for two ANDs, but the four stamp-plane kernels handle 32 four-bit
// stamps per word.
//
// Two designs.  merge_incoming takes one fact at a time (restamp_word):
// extract the nibble, subtract, mask, compare, select, shift it back — a
// few hundred instructions per word, which holds it at 58-72% of its
// byte bound.  The other stamp-plane kernels were built the same way
// and sat lower, held back by instruction issue: select_packets and
// fused_flush at 48-49%, fused_merge (691 SASS instructions a word) at
// 57-58%.  They now work on nibble lanes (the section of that name
// below): four byte lanes per 32-bit operation, ~16 operations per 8
// facts for the select and ~45 for the flush, where the per-fact loops
// took ~60 and ~110; the merge runs the flush's lanes without the
// overlay pass (merge_packed / merge_unpacked).  The bound they aim at
// is their bytes: 14.63 us, 28.66 us and 28.96 us at N = 1M, K = 64
// packed (PERF.md).  A lane kernel's thread owns one word and indexes
// with 32 bits: word t's stamp chunk is chunk t, so only the select and
// the merge divide (32 bits, by the runtime W) to find the row's alive
// byte.  With 2048 threads resident an SM has 40-60 KB of loads in
// flight (packed), more than its ~16 KB share of the ~2 MB that HBM's
// rate times its latency asks for.  The cached select reads no stamp: a
// thread owns four words (16-byte loads and a 16-byte store, 32-bit
// indexing, a row's alive byte read once) where it owned one.
//
// Sharded meshes.  On a mesh of P virtual shards of one device the
// shards are contiguous row blocks of each plane.  fused_merge then runs
// one launch on a two-dimensional grid, the shard in blockIdx.y, so
// that no block spans two shards and the learn counts stay one per
// block of a shard, in shard order.  The other kernels that take a mesh
// (select_packets, the cached select, fused_flush) have row-local
// outputs and no per-shard output, so one launch covers the whole plane
// as unsharded.
//
// The TPU kernels' per-grid-step learn flag becomes one count per CUDA
// block (blocks run in no order; the caller only asks whether any count
// is non-zero).  Kernels never allocate and never synchronise; the caller
// passes outputs allocated with torch.empty and the current stream.
// Round scalars are read from device memory (a 0-d int32 tensor), and
// each kernel derives the stamp quarters it needs, so the host never
// waits on the device to launch a round.

#include <climits>
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

// -- one fact at a time (merge_incoming) -------------------------------------

// re-pin a wrap-stale stamp at q-age kAgePinQ (dissemination.clamp_nibbles)
__device__ __forceinline__ int clamped(int rq, int nib) {
  return ((rq - nib) & 0xF) > kAgePinQ ? ((rq - kAgePinQ) & 0xF) : nib;
}

// one fact's new stamp: clamp at rq, then a fresh learn writes rq
__device__ __forceinline__ int restamped(uint32_t fresh, int rq, int nib) {
  return (fresh & 1u) ? rq : clamped(rq, nib);
}

__device__ __forceinline__ int byte_of(const uint32_t* q, int j) {
  return (q[j >> 2] >> (8 * (j & 3))) & 0xFF;
}

// The standalone merge's stamp pass of one word: read the word's stamp
// bytes at `in`, restamp every fact (restamped) and write the bytes to
// `out`.
template <bool kPacked>
__device__ __forceinline__ void restamp_word(const uint8_t* in, uint8_t* out,
                                             uint32_t fresh, int rq) {
  if (kPacked) {
    const uint4 v = *reinterpret_cast<const uint4*>(in);
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int b = byte_of(q, j);
      const int lo = restamped(fresh >> (2 * j), rq, b & 0xF);
      const int hi = restamped(fresh >> (2 * j + 1), rq, b >> 4);
      o[j >> 2] |= uint32_t(lo | (hi << 4)) << (8 * (j & 3));
    }
    *reinterpret_cast<uint4*>(out) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
    const uint4* p = reinterpret_cast<const uint4*>(in);
    const uint4 a = p[0], c = p[1];
    const uint32_t q[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
    uint32_t o[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int nib = restamped(fresh >> j, rq, byte_of(q, j));
      o[j >> 2] |= uint32_t(nib & 0xFF) << (8 * (j & 3));
    }
    uint4* d = reinterpret_cast<uint4*>(out);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// byte offset of word w's stamp chunk in row `row`
template <bool kPacked>
__device__ __forceinline__ int64_t chunk_of(int64_t row, int w, int cols) {
  return row * cols + (kPacked ? 16 : 32) * w;
}

// -- nibble lanes (select_packets, fused_flush) ------------------------------
//
// A 32-bit word of stamp bytes is four byte lanes.  Each lane works on a
// 4-bit stamp in its low half, so it has four bits of headroom: no lane
// ever carries into or borrows from its neighbour, and one operation does
// the work of four facts.  tests/test_torch_swar.py transliterates every
// helper of this section line for line (same constants, same order of
// operations, under the same name) and checks it exhaustively against
// the per-fact definitions of models/dissemination.py.

constexpr uint32_t kOnes = 0x01010101u;   // 1 in every lane
constexpr uint32_t kLow = 0x0F0F0F0Fu;    // the low nibble of every lane
constexpr uint32_t kTop = 0x80808080u;    // the top bit of every lane

// prmt.b32: byte n of the result is byte (sel >> 4n) & 7 of the pair
// (a = bytes 0-3, b = bytes 4-7); where bit 3 of that selector is set,
// the chosen byte's top bit is copied over all 8 bits instead
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// rq + 16 in every lane: a lane minus a nibble never borrows
__device__ __forceinline__ uint32_t quarter_lanes(int rq) {
  return uint32_t(rq) * kOnes | 0x10101010u;
}

// the q-age (rq - nib) & 0xF of four nibbles (each below 16) at once
__device__ __forceinline__ uint32_t age_lanes(uint32_t nibs, uint32_t rq16) {
  return (rq16 - nibs) & kLow;
}

// 0x80 in each lane whose q-age is below the limit: `lim` holds 0x80 -
// limit in every lane (limit_lanes), so age + lim reaches the lane's top
// bit exactly when age >= limit
__device__ __forceinline__ uint32_t young_lanes(uint32_t nibs, uint32_t rq16,
                                                uint32_t lim) {
  return ~(age_lanes(nibs, rq16) + lim) & kTop;
}

// 0xFF in each lane whose top bit is set, 0 in the others
__device__ __forceinline__ uint32_t lane_masks(uint32_t x) {
  return prmt(x, 0u, 0xBA98u);
}

// b in the lanes where mask m is set, a in the others (one LOP3)
__device__ __forceinline__ uint32_t pick(uint32_t m, uint32_t b,
                                         uint32_t a) {
  return (b & m) | (a & ~m);
}

// dissemination.clamp_nibbles on four lanes: a lane whose q-age (from
// its nibble `nibs`) is above kAgePinQ takes the pin quarter `pin`; the
// others keep their byte `keep`
__device__ __forceinline__ uint32_t clamp_lanes(uint32_t keep, uint32_t nibs,
                                                uint32_t rq16, uint32_t pin) {
  return pick(lane_masks(age_lanes(nibs, rq16) + (0x7Fu - kAgePinQ) * kOnes),
              pin, keep);
}

// packed: 0xFF in lane j of `lo` (of `hi`) where bit 2j (2j+1) of byte b
// of a fact word is set — the facts of stamp byte 4b+j's low (high) nibble
__device__ __forceinline__ void pair_masks(uint32_t word, int b, uint32_t& lo,
                                           uint32_t& hi) {
  const uint32_t r = prmt(word, 0u, b * 0x1111u);   // byte b in every lane
  lo = lane_masks((r & 0x40100401u) + 0x7F7F7F7Fu);
  hi = lane_masks((r & 0x80200802u) + 0x7F7F7F7Fu);
}

// unpacked: 0xFF in lane j where bit 4g+j of a fact word is set — the
// facts of the word's stamp bytes 4g..4g+3
__device__ __forceinline__ uint32_t quad_masks(uint32_t word, int g) {
  const uint32_t r = prmt(word, 0u, (g >> 1) * 0x1111u);
  return lane_masks((r & ((g & 1) ? 0x80402010u : 0x08040201u))
                    + 0x7F7F7F7Fu);
}

// packed: the lane top bits of a group's low and high nibbles (lane j =
// facts 2j, 2j+1) gathered as bits 24 + 2j and 25 + 2j of the product
__device__ __forceinline__ uint32_t weave_pairs(uint32_t lo, uint32_t hi) {
  return ((lo >> 1) | hi) * 0x00041041u;
}

// unpacked: the lane top bits of two groups (facts 0-3 in a, 4-7 in b)
// gathered as bits 24..31 of the product
__device__ __forceinline__ uint32_t weave_quads(uint32_t a, uint32_t b) {
  return ((a >> 4) | b) * 0x00204081u;
}

// the top bytes of four woven products as one fact word (product i ->
// byte i)
__device__ __forceinline__ uint32_t top_bytes(uint32_t p0, uint32_t p1,
                                              uint32_t p2, uint32_t p3) {
  return prmt(prmt(p0, p1, 0x0073u), prmt(p2, p3, 0x0073u), 0x5410u);
}

// the age bits of one word's 16 packed stamp bytes (select_packets)
__device__ __forceinline__ uint32_t young_packed(uint4 v, uint32_t rq16,
                                                 uint32_t lim) {
  const uint32_t q[4] = {v.x, v.y, v.z, v.w};
  uint32_t p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[i] = weave_pairs(young_lanes(q[i] & kLow, rq16, lim),
                       young_lanes((q[i] >> 4) & kLow, rq16, lim));
  }
  return top_bytes(p[0], p[1], p[2], p[3]);
}

// the age bits of one word's 32 unpacked stamp bytes (select_packets)
__device__ __forceinline__ uint32_t young_unpacked(uint4 a, uint4 b,
                                                   uint32_t rq16,
                                                   uint32_t lim) {
  const uint32_t q[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[i] = weave_quads(young_lanes(q[2 * i] & kLow, rq16, lim),
                       young_lanes(q[2 * i + 1] & kLow, rq16, lim));
  }
  return top_bytes(p[0], p[1], p[2], p[3]);
}

// a flush's quarters, each in every lane
struct FlushLanes {
  uint32_t rq16;     // quarter_lanes(rq)
  uint32_t rq;       // the flush round's quarter: fresh learns
  uint32_t rq_prev;  // the cohort's quarter: pending overlay cells
  uint32_t pin;      // (rq - kAgePinQ) & 0xF: wrap-stale stamps
  uint32_t lim;      // limit_lanes(limit_q)
};

__device__ __forceinline__ FlushLanes flush_lanes(int32_t next_round,
                                                  uint32_t lim) {
  const int rq = quarter(next_round);
  return FlushLanes{quarter_lanes(rq), uint32_t(rq) * kOnes,
                    uint32_t(quarter(next_round - 1)) * kOnes,
                    uint32_t((rq - kAgePinQ) & 0xF) * kOnes, lim};
}

// The cohort flush of one word's 16 packed stamp bytes: clamp, pending
// overlay cells -> rq_prev (kOverlay), fresh learns -> rq (written last,
// so a fresh learn wins); stores the new bytes at *out and returns
// (kWithCache) the age bits of the final nibbles while they are still in
// registers.
template <bool kWithCache, bool kOverlay = true>
__device__ __forceinline__ uint32_t flush_packed(uint4 v, uint32_t fresh,
                                                 uint32_t overlay,
                                                 const FlushLanes& l,
                                                 uint4* out) {
  const uint32_t q[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[4], p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t lo = q[i] & kLow, hi = (q[i] >> 4) & kLow, m_lo, m_hi;
    lo = clamp_lanes(lo, lo, l.rq16, l.pin);
    hi = clamp_lanes(hi, hi, l.rq16, l.pin);
    if (kOverlay) {
      pair_masks(overlay, i, m_lo, m_hi);
      lo = pick(m_lo, l.rq_prev, lo);
      hi = pick(m_hi, l.rq_prev, hi);
    }
    pair_masks(fresh, i, m_lo, m_hi);
    lo = pick(m_lo, l.rq, lo);
    hi = pick(m_hi, l.rq, hi);
    o[i] = lo | (hi << 4);
    if (kWithCache) {
      p[i] = weave_pairs(young_lanes(lo, l.rq16, l.lim),
                         young_lanes(hi, l.rq16, l.lim));
    }
  }
  *out = make_uint4(o[0], o[1], o[2], o[3]);
  return kWithCache ? top_bytes(p[0], p[1], p[2], p[3]) : 0u;
}

// flush_packed for one word's 32 unpacked stamp bytes (a clamp keeps a
// young byte whole, as dissemination.clamp_nibbles does)
template <bool kWithCache, bool kOverlay = true>
__device__ __forceinline__ uint32_t flush_unpacked(uint4 a, uint4 b,
                                                   uint32_t fresh,
                                                   uint32_t overlay,
                                                   const FlushLanes& l,
                                                   uint4* out) {
  const uint32_t q[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t o[8], y[8];
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    uint32_t s = clamp_lanes(q[g], q[g] & kLow, l.rq16, l.pin);
    if (kOverlay) s = pick(quad_masks(overlay, g), l.rq_prev, s);
    s = pick(quad_masks(fresh, g), l.rq, s);
    o[g] = s;
    if (kWithCache) y[g] = young_lanes(s & kLow, l.rq16, l.lim);
  }
  out[0] = make_uint4(o[0], o[1], o[2], o[3]);
  out[1] = make_uint4(o[4], o[5], o[6], o[7]);
  return kWithCache ? top_bytes(weave_quads(y[0], y[1]),
                                weave_quads(y[2], y[3]),
                                weave_quads(y[4], y[5]),
                                weave_quads(y[6], y[7]))
                    : 0u;
}

// The merge's stamp pass of one word's 16 packed stamp bytes: the
// flush's lanes without the overlay, so each fact becomes
// restamped(fresh, rq, nib) — a fresh learn takes rq, every other stamp
// is clamped at rq — with the cache's age bits of the result
template <bool kWithCache>
__device__ __forceinline__ uint32_t merge_packed(uint4 v, uint32_t fresh,
                                                 const FlushLanes& l,
                                                 uint4* out) {
  return flush_packed<kWithCache, false>(v, fresh, 0u, l, out);
}

// merge_packed for one word's 32 unpacked stamp bytes
template <bool kWithCache>
__device__ __forceinline__ uint32_t merge_unpacked(uint4 a, uint4 b,
                                                   uint32_t fresh,
                                                   const FlushLanes& l,
                                                   uint4* out) {
  return flush_unpacked<kWithCache, false>(a, b, fresh, 0u, l, out);
}

// -- kernels -----------------------------------------------------------------

// packets = known & age_ok & alive, a read-only pass over the stamp plane
// (replaces _make_select_kernel).  Nibble lanes: ~16 integer operations
// per 8 facts, against ~60 in the per-fact loop it replaces (30.3 us on
// an H100), so that its 49 MB of bytes (14.63 us at N = 1M) come near
// binding it (PERF.md: ~18.4 us).  The row divide is by the runtime W:
// a compile-time W = 2 instance saved 2% on an H100 (PERF.md) and is
// not worth a second instance.
template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
select_packets_kernel(const uint4* __restrict__ stamp,
                      const uint32_t* __restrict__ known,
                      const uint8_t* __restrict__ alive,
                      const int32_t* __restrict__ round,
                      uint32_t* __restrict__ packets, uint32_t total,
                      uint32_t words, uint32_t lim) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const uint32_t rq16 = quarter_lanes(quarter(*round));
  const uint32_t age_ok =
      kPacked ? young_packed(stamp[t], rq16, lim)
              : young_unpacked(stamp[2 * t], stamp[2 * t + 1], rq16, lim);
  packets[t] = alive[t / words] ? known[t] & age_ok : 0u;
}

// packets = sendable & known & alive — the word plane only, no stamp
// read.  A thread owns four consecutive words: one 16-byte load of each
// plane and one 16-byte store, the row of its first word from a 32-bit
// divide and each later row by counting (so a row's alive byte is read
// once per thread that touches it); the last thread takes total % 4
// words one at a time.  12 bytes a word; the one-word form it replaces
// (4-byte loads, a 64-bit index and divide per word) read 64-66% of that
// bound at N = 1M, K = 64 and 36-37% on a shard's 125,000 rows
// (PERF.md).
__global__ void __launch_bounds__(kThreads)
fused_select_kernel(const uint4* __restrict__ sendable,
                    const uint4* __restrict__ known,
                    const uint8_t* __restrict__ alive,
                    uint4* __restrict__ packets, uint32_t total,
                    uint32_t words) {
  const uint32_t quad = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t t = 4u * quad;
  if (t >= total) return;
  if (t + 4u > total) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(sendable);
    const uint32_t* k = reinterpret_cast<const uint32_t*>(known);
    uint32_t* p = reinterpret_cast<uint32_t*>(packets);
    for (uint32_t u = t; u < total; ++u) {
      p[u] = alive[u / words] ? (s[u] & k[u]) : 0u;
    }
    return;
  }
  const uint4 s = sendable[quad], k = known[quad];
  const uint32_t sv[4] = {s.x, s.y, s.z, s.w};
  const uint32_t kv[4] = {k.x, k.y, k.z, k.w};
  uint32_t row = t / words, col = t - row * words;
  uint32_t live = alive[row] ? 0xFFFFFFFFu : 0u;
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j > 0 && ++col == words) {
      col = 0u;
      live = alive[++row] ? 0xFFFFFFFFu : 0u;
    }
    o[j] = sv[j] & kv[j] & live;
  }
  packets[quad] = make_uint4(o[0], o[1], o[2], o[3]);
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
  restamp_word<kPacked>(stamp + off, stamp_out + off, fresh, rq);
}

// learn, clamp, stamp the learned nibbles with the next round's quarter,
// and (kWithCache) recompute sendable' = known' & (q-age' < limit_q) from
// the new nibbles while they are still in registers.  Nibble lanes
// (merge_packed / merge_unpacked): the flush's lane sequence without its
// overlay pass, where the per-fact loop it replaces took 691 SASS
// instructions a word and read 57-58% of its 97 MB byte bound (28.96 us
// at N = 1M, K = 64).  The grid is (blocks of a shard) x (shards): block
// (x, y) covers words y * shard_total + [256x, 256x + 256) of shard y,
// and writes its learn count at flags[y * gridDim.x + x], so the counts
// of a shard's blocks stay in one run, in shard order (one shard: the
// unsharded launch).
template <bool kPacked, bool kWithCache>
__global__ void __launch_bounds__(kThreads)
fused_merge_kernel(const uint32_t* __restrict__ known,
                   const uint32_t* __restrict__ incoming,
                   const uint8_t* __restrict__ alive,
                   const uint4* __restrict__ stamp,
                   const int32_t* __restrict__ next_round,
                   uint32_t* __restrict__ known_out,
                   uint4* __restrict__ stamp_out,
                   uint32_t* __restrict__ sendable_out,
                   int32_t* __restrict__ flags, uint32_t shard_total,
                   uint32_t words, uint32_t lim) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t t = blockIdx.y * shard_total + i;
  uint32_t fresh = 0u;
  if (i < shard_total) {
    const uint32_t k0 = known[t];
    fresh = incoming[t] & ~k0 & (alive[t / words] ? 0xFFFFFFFFu : 0u);
    const uint32_t k1 = k0 | fresh;
    known_out[t] = k1;
    const FlushLanes l = flush_lanes(*next_round, lim);
    const uint32_t ok =
        kPacked ? merge_packed<kWithCache>(stamp[t], fresh, l, stamp_out + t)
                : merge_unpacked<kWithCache>(stamp[2 * t], stamp[2 * t + 1],
                                             fresh, l, stamp_out + 2 * t);
    if (kWithCache) sendable_out[t] = k1 & ok;
  }
  // every thread of the block reaches this barrier (no early return)
  const int learned = __syncthreads_count(fresh != 0u);
  if (threadIdx.x == 0) flags[blockIdx.y * gridDim.x + blockIdx.x] = learned;
}

// The deferred flavor's cohort flush (replaces _make_fused_flush_kernel):
// clamp at the flush round's quarter, pending overlay cells -> the
// cohort quarter, this merge's learns -> the flush round's quarter (a
// fresh learn wins over an overlay bit), then (kWithCache) the sendable
// cache from the final nibbles.  known2 is the post-merge known plane,
// read only for the cache.  Nibble lanes: ~45 integer operations per 8
// facts, against ~110 in the per-fact loop it replaces (58.8 us on an
// H100), so that its 96 MB of bytes (28.66 us at N = 1M) come near
// binding it (PERF.md: ~33.9 us).  No row index: the flush reads no
// alive byte.
template <bool kPacked, bool kWithCache>
__global__ void __launch_bounds__(kThreads)
fused_flush_kernel(const uint32_t* __restrict__ known2,
                   const uint32_t* __restrict__ new_words,
                   const uint32_t* __restrict__ overlay,
                   const uint4* __restrict__ stamp,
                   const int32_t* __restrict__ next_round,
                   uint4* __restrict__ stamp_out,
                   uint32_t* __restrict__ sendable_out, uint32_t total,
                   uint32_t lim) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const FlushLanes l = flush_lanes(*next_round, lim);
  const uint32_t ok =
      kPacked ? flush_packed<kWithCache>(stamp[t], new_words[t], overlay[t],
                                         l, stamp_out + t)
              : flush_unpacked<kWithCache>(stamp[2 * t], stamp[2 * t + 1],
                                           new_words[t], overlay[t], l,
                                           stamp_out + 2 * t);
  if (kWithCache) sendable_out[t] = known2[t] & ok;
}

inline unsigned blocks_for(int64_t total) {
  return unsigned((total + kThreads - 1) / kThreads);
}

// The lane kernels index words with 32 bits (at most 2^31 - 1 words, a
// 32 GiB packed stamp plane) and read word t's stamps as chunk t, which
// needs rows of exactly 16 (packed) or 32 (unpacked) bytes per word.
inline bool lane_shape_ok(int64_t total, int words, int cols, int packed) {
  return total <= INT_MAX && cols == (packed ? 16 : 32) * words;
}

// 0x80 - limit_q in every lane (young_lanes), the limit clamped to 0..16
// first: a q-age is 0..15, so a limit outside that range selects what
// its clamp selects.  tests/test_torch_swar.py: limit_lanes.
inline uint32_t limit_lanes(int limit_q) {
  const int lq = limit_q < 0 ? 0 : (limit_q > 16 ? 16 : limit_q);
  return uint32_t(0x80 - lq) * 0x01010101u;
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
  if (!lane_shape_ok(total, words, cols, packed)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  dispatch(packed, 0, [&](auto p, auto) {
    select_packets_kernel<decltype(p)::value>
        <<<blocks_for(total), kThreads, 0, s>>>(
            in<uint4>(stamp), in<uint32_t>(known), in<uint8_t>(alive),
            in<int32_t>(round), out<uint32_t>(packets), uint32_t(total),
            uint32_t(words), limit_lanes(limit_q));
  });
  return static_cast<int>(cudaGetLastError());
}

int serf_fused_select_cached(const void* sendable, const void* known,
                             const void* alive, void* packets, int64_t n,
                             int words, void* stream) {
  const int64_t total = n * words;
  if (total == 0) return 0;
  if (total > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fused_select_kernel<<<blocks_for((total + 3) / 4), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      in<uint4>(sendable), in<uint4>(known), in<uint8_t>(alive),
      out<uint4>(packets), uint32_t(total), uint32_t(words));
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

// shards > 1: one launch over a mesh's `shards` contiguous row blocks of
// n / shards rows each (the caller checks that they divide n); flags
// holds shards x blocks_for(n / shards * words) counts
int serf_fused_merge(const void* known, const void* incoming,
                     const void* alive, const void* stamp,
                     const void* next_round, void* known_out,
                     void* stamp_out, void* sendable_out, void* flags,
                     int64_t n, int words, int cols, int limit_q, int packed,
                     int with_cache, int shards, void* stream) {
  const int64_t total = n * words;
  if (total == 0) return 0;
  if (!lane_shape_ok(total, words, cols, packed) || shards < 1 ||
      shards > 65535 || n % shards != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t shard_total = total / shards;
  const dim3 grid(blocks_for(shard_total), unsigned(shards));
  auto s = static_cast<cudaStream_t>(stream);
  dispatch(packed, with_cache, [&](auto p, auto c) {
    fused_merge_kernel<decltype(p)::value, decltype(c)::value>
        <<<grid, kThreads, 0, s>>>(
            in<uint32_t>(known), in<uint32_t>(incoming), in<uint8_t>(alive),
            in<uint4>(stamp), in<int32_t>(next_round),
            out<uint32_t>(known_out), out<uint4>(stamp_out),
            out<uint32_t>(sendable_out), out<int32_t>(flags),
            uint32_t(shard_total), uint32_t(words), limit_lanes(limit_q));
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
  if (!lane_shape_ok(total, words, cols, packed)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  dispatch(packed, with_cache, [&](auto p, auto c) {
    fused_flush_kernel<decltype(p)::value, decltype(c)::value>
        <<<blocks_for(total), kThreads, 0, s>>>(
            in<uint32_t>(known2), in<uint32_t>(new_words),
            in<uint32_t>(overlay), in<uint4>(stamp),
            in<int32_t>(next_round), out<uint4>(stamp_out),
            out<uint32_t>(sendable_out), uint32_t(total),
            limit_lanes(limit_q));
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
