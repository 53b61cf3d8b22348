// Draws: every uniform of an i.i.d. batch, made on the card by replaying,
// bit for bit, the CPU generator streams the host path draws them from
// (sample/replay.py; its plain version is replay.host_draws).
//
// Replaces no Pallas kernel. The JAX package folds jax.random keys on the
// accelerator (a scene key a cadence group, a frame key a frame: its
// parallel/pipeline.py); the port draws the same uniforms from one CPU
// torch.Generator a scene group, a frame and a camera-mix coin
// (utils/prng.py), 564 generators a 512-frame batch. This kernel puts the
// draws back on the device: one launch in place of that host loop.
//
// A stream: the generator of (seed, stream, index) is seeded with
// prng.mix(seed, stream, index), splitmix64 folded over the three words,
// and at::mt19937 keeps its low 32 bits (init_with_uint32); its first draw
// twists the whole 624-word state. A float32 of torch.rand is one tempered
// word w, (w & 0xFFFFFF) * 2^-24; torch.randperm(n) on the CPU takes n - 1
// words, step i swapping r[i] with r[i + w % (n - i)]. A scene group's
// stream follows placement.scene_draws key by key (2963 words under the
// default config), a frame's is camera_draws then lighting_draws (12
// words), a coin's one word of MIX_STREAM.
//
// What bounds it on an H100: latency, not bytes. A 512-frame batch writes
// ~0.64 MB (0.2 us at 3.35 TB/s), while seeding a stream is a chain of 623
// dependent steps and each twist depends on the one before.
//
// Design: one warp a scene stream. Lane 0 seeds the state into shared
// memory; the lanes twist it in MT's three ranges whose words depend only
// on words made before the range (0-226 on the old state, 227-453 on the
// first range's, 454-623 on the second's), each lane making its up to 8
// words of a range together. Then the warp writes the 624 words out
// segment by segment of the word layout (a table: first word, words, the
// key's offset and size per group, the offset in the key, n of a randperm
// or 0 for floats), read from the warp's copy in shared memory, loaded
// while lane 0 seeds; lanes take consecutive words of a segment, so the
// stores coalesce and no lane branches apart, where a cursor per lane
// would cross every segment. A randperm's words go out raw and one lane
// turns them into the permutation at the end, its entries packed in a
// register. The seeding chain sets the time: 623 dependent steps of three
// instructions each (seed_step). One thread a frame or coin stream: its
// first 12 words need state words 0-12 and 397-408 only, so the seeding
// chain stops at 408 and keeps those in registers. One launch a batch, no
// shared state between blocks, nothing allocated.
#include <cstdint>

#include "common.cuh"

namespace cspe {
namespace {

constexpr int kN = 624;  // MT19937's state words
constexpr int kM = 397;
constexpr int kRange = kN - kM;  // 227: the words of a twist's first range
constexpr int kPerLane = (kRange + 31) / 32;  // a lane's words of a range
// A stream's state in shared memory: its 624 words, word 0's new value
// again at 624 (word 623's neighbour), and room for the reads of the lanes
// past a range's end, whose words are made and dropped.
constexpr int kStateWords = 2 * kRange + 32 * kPerLane + 2;
constexpr uint32_t kMatrixA = 0x9908b0dfu;
constexpr int kSegCols = 6;        // sample/replay.SEG_COLS
constexpr int kMaxSeg = 64;        // sample/replay.MAX_SEGMENTS
constexpr int kTabPerLane = (kMaxSeg * kSegCols + 31) / 32;
constexpr int kFrameWords = 12;    // sample/replay.FRAME_WORDS
constexpr int kMaxPerm = 8;        // sample/replay.MAX_PERM: 4 bits an entry of a uint32
constexpr int kSceneWarps = 4;     // scene streams a block
constexpr int kStreamThreads = 128;  // frame and coin streams a block
static_assert(kSceneWarps * 32 == kStreamThreads, "one block size for both roles");

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// The MT19937 seed of prng.mix(seed, stream, index), given key =
// prng.mix(seed, stream): the low 32 bits of one more splitmix64 fold.
__device__ __forceinline__ uint32_t stream_seed(uint64_t key, int index) {
  return static_cast<uint32_t>(
      splitmix64(key ^ static_cast<uint64_t>(static_cast<int64_t>(index))));
}

// x_j of the seeding from x_{j-1}. The empty asm keeps j a register of its
// own, so that nvcc adds it in the multiply-add: unrolled, nvcc adds a
// shared base there and j's offset after, a fourth step on the chain.
__device__ __forceinline__ uint32_t seed_step(uint32_t x, uint32_t j) {
  asm("" : "+r"(j));
  return 1812433253u * (x ^ (x >> 30)) + j;
}

__device__ __forceinline__ uint32_t twist(uint32_t u, uint32_t v) {
  return (((u & 0x80000000u) | (v & 0x7fffffffu)) >> 1) ^ ((v & 1u) ? kMatrixA : 0u);
}

__device__ __forceinline__ uint32_t temper(uint32_t y) {
  y ^= y >> 11;
  y ^= (y << 7) & 0x9d2c5680u;
  y ^= (y << 15) & 0xefc60000u;
  return y ^ (y >> 18);
}

// torch.rand's float32 of a word: its low 24 bits times 2^-24, exact.
__device__ __forceinline__ float unit_float(uint32_t w) {
  return static_cast<float>(w & 0xFFFFFFu) * 5.9604644775390625e-08f;
}

struct Args {
  const int* frame_ids;  // (B,)
  const int* group_ids;  // (G,)
  const int* layout;     // (n_seg, kSegCols)
  uint64_t scene_key, frame_key, mix_key;
  int n_frames, n_groups, coins, n_seg, words, floats;
  float* out;  // G * floats key-major, then (B, 12) frames, then (B,) coins
};

__device__ void scene_stream(const Args& a, int g, uint32_t* s, int* tab, int lane) {
  // The table's loads are issued before the seeding and land after it.
  int held[kTabPerLane];
  const int n_tab = a.n_seg * kSegCols;
#pragma unroll
  for (int t = 0; t < kTabPerLane; ++t)
    if (lane + 32 * t < n_tab) held[t] = a.layout[lane + 32 * t];
  if (lane == 0) {
    uint32_t x = stream_seed(a.scene_key, a.group_ids[g]);
    s[0] = x;
    for (int j = 1; j < kN; ++j) {
      x = seed_step(x, j);
      s[j] = x;
    }
  }
#pragma unroll
  for (int t = 0; t < kTabPerLane; ++t)
    if (lane + 32 * t < n_tab) tab[lane + 32 * t] = held[t];
  __syncwarp();
  int p0 = 0;  // the first segment that still has words to write
  for (int base = 0; base < a.words; base += kN) {
    // In place, as at::mt19937's next_state: word i takes the old words i
    // and i + 1 (word 0's new value for i = 623, kept again at 624) and word
    // i + 397 mod 624, which is old in the first range and made by an
    // earlier range after. A lane makes its words of a range at once
    // (words lane, lane + 32, ...) and writes them when every lane has read
    // what they overwrite; the words past the range's end are dropped.
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int lo = r * kRange, hi = r == 2 ? kN : lo + kRange;
      uint32_t y[kPerLane];
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) {
        const int i = lo + lane + 32 * c;
        y[c] = s[r == 0 ? i + kM : i - kRange] ^ twist(s[i], s[i + 1]);
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kPerLane; ++c)
        if (lo + lane + 32 * c < hi) s[lo + lane + 32 * c] = y[c];
      if (r == 0 && lane == 0) s[kN] = y[0];
      __syncwarp();
    }
    // The block's words out, segment by segment (the same segments for the
    // whole warp, so no lane waits on another's branch).
    const int end = min(base + kN, a.words);
    for (int p = p0; p < a.n_seg && tab[p * kSegCols] < end; ++p) {
      const int* row = tab + p * kSegCols;
      const int last = row[0] + row[1], stop = min(last, end) - base;
      float* o = a.out + static_cast<int64_t>(row[2]) * a.n_groups +
                 static_cast<int64_t>(g) * row[3] + row[4] + base - row[0];
      if (row[5]) {
        for (int i = max(row[0], base) - base + lane; i < stop; i += 32)
          o[i] = __uint_as_float(temper(s[i]));
      } else {
#pragma unroll 4
        for (int i = max(row[0], base) - base + lane; i < stop; i += 32)
          o[i] = unit_float(temper(s[i]));
      }
      if (last <= end) p0 = p + 1;
    }
    __syncwarp();  // every lane has read the words the next twist overwrites,
  }                // and the raw randperm words are in place
  for (int p = lane; p < a.n_seg; p += 32) {
    const int* row = tab + p * kSegCols;
    const int n = row[5];
    if (n == 0) continue;
    float* o = a.out + static_cast<int64_t>(row[2]) * a.n_groups +
               static_cast<int64_t>(g) * row[3] + row[4];
    uint32_t w[kMaxPerm - 1];
#pragma unroll
    for (int i = 0; i + 1 < kMaxPerm; ++i)
      if (i + 1 < n) w[i] = __float_as_uint(o[i]);
    // r[i] in bits 4i..4i+3; swapping r[i] and r[j] flips both by r[i] ^ r[j].
    uint32_t r = 0;
#pragma unroll
    for (int i = 0; i < kMaxPerm; ++i) r |= static_cast<uint32_t>(i) << (4 * i);
#pragma unroll
    for (int i = 0; i + 1 < kMaxPerm; ++i) {
      if (i + 1 >= n) break;
      const int j = i + static_cast<int>(w[i] % static_cast<uint32_t>(n - i));
      const uint32_t d = ((r >> (4 * i)) ^ (r >> (4 * j))) & 15u;
      r ^= (d << (4 * i)) | (d << (4 * j));
    }
    for (int i = 0; i < n; ++i) o[i] = static_cast<float>((r >> (4 * i)) & 15u);
  }
}

// The first ``n`` (<= kFrameWords) floats of the stream seeded ``seed``.
__device__ void short_stream(uint32_t seed, int n, float* out) {
  uint32_t lo[kFrameWords + 1], hi[kFrameWords];
  uint32_t x = seed;
  lo[0] = x;
#pragma unroll
  for (int j = 1; j <= kFrameWords; ++j) lo[j] = x = seed_step(x, j);
#pragma unroll 4
  for (int j = kFrameWords + 1; j < kM; ++j) x = seed_step(x, j);
#pragma unroll
  for (int j = 0; j < kFrameWords; ++j) hi[j] = x = seed_step(x, kM + j);
#pragma unroll
  for (int i = 0; i < kFrameWords; ++i)
    if (i < n) out[i] = unit_float(temper(hi[i] ^ twist(lo[i], lo[i + 1])));
}

__global__ void __launch_bounds__(kStreamThreads) draws_kernel(const Args a) {
  __shared__ uint32_t state[kSceneWarps][kStateWords];
  __shared__ int tables[kSceneWarps][kMaxSeg * kSegCols];
  const int scene_blocks = (a.n_groups + kSceneWarps - 1) / kSceneWarps;
  if (static_cast<int>(blockIdx.x) < scene_blocks) {
    const int warp = threadIdx.x / 32;
    const int g = blockIdx.x * kSceneWarps + warp;
    if (g < a.n_groups) scene_stream(a, g, state[warp], tables[warp], threadIdx.x % 32);
    return;
  }
  const int t = (blockIdx.x - scene_blocks) * kStreamThreads + threadIdx.x;
  float* frames = a.out + static_cast<int64_t>(a.n_groups) * a.floats;
  if (t < a.n_frames) {
    short_stream(stream_seed(a.frame_key, a.frame_ids[t]), kFrameWords,
                 frames + static_cast<int64_t>(t) * kFrameWords);
  } else if (a.coins && t < 2 * a.n_frames) {
    const int f = t - a.n_frames;
    short_stream(stream_seed(a.mix_key, a.frame_ids[f]), 1,
                 frames + static_cast<int64_t>(a.n_frames) * kFrameWords + f);
  }
}

}  // namespace
}  // namespace cspe

// frame_ids (B,), group_ids (G,) and layout (n_seg, 6) int32 -> out f32:
// G * floats scene floats, key by key as (G, ...) blocks, then (B, 12)
// frame uniforms, then with coins (B,) coin uniforms. The keys are
// prng.mix(seed, stream) of SCENE_STREAM, FRAME_STREAM and MIX_STREAM; the
// table's at most 64 rows start at increasing words and cover words
// 0..words-1, a randperm row's n is at most 8 (sample/replay.word_layout
// builds it so).
CSPE_API int cspe_draws(const int* frame_ids, int n_frames, const int* group_ids, int n_groups,
                        int coins, uint64_t scene_key, uint64_t frame_key, uint64_t mix_key,
                        const int* layout, int n_seg, int words, int floats, float* out,
                        cudaStream_t stream) {
  using namespace cspe;
  if (n_frames < 0 || n_groups < 0 || n_seg <= 0 || n_seg > kMaxSeg || words <= 0 ||
      floats < words)
    return kErrArgument;
  const int scene_blocks = (n_groups + kSceneWarps - 1) / kSceneWarps;
  const int streams = coins ? 2 * n_frames : n_frames;
  const int blocks = scene_blocks + (streams + kStreamThreads - 1) / kStreamThreads;
  if (blocks == 0) return 0;
  const Args a{frame_ids, group_ids, layout, scene_key, frame_key, mix_key, n_frames,
               n_groups,  coins,     n_seg,  words,     floats,    out};
  draws_kernel<<<blocks, kStreamThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
