// Native IO runtime: hot host-side conversions feeding the device pipeline.
//
// The framework's device ops consume complex64; captures arrive as interleaved
// uint8 IQ bytes (SDRSharp wav / raw dat; see directdemod_tpu/io/sources.py
// for the byte-level contract mirrored from the reference reader,
// reference source.py:117-118,209). This unpack runs at memory bandwidth and
// is the host bottleneck when streaming multi-GB captures, hence C++ with
// thread-parallel, auto-vectorized inner loops.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline void convert_range(const uint8_t* src, float* dst, int64_t begin,
                          int64_t end) {
  // dst is the complex64 buffer viewed as float pairs: [re0 im0 re1 im1 ...]
  const uint8_t* s = src + 2 * begin;
  float* d = dst + 2 * begin;
  int64_t n = 2 * (end - begin);
  for (int64_t i = 0; i < n; ++i) {
    d[i] = static_cast<float>(s[i]) - 127.5f;
  }
}

}  // namespace

extern "C" {

// Interleaved uint8 IQ -> complex64 with the -127.5 DC offset.
// n = number of complex samples; threads = 0 -> hardware concurrency.
void iq_u8_to_c64(const void* src_v, void* dst_v, long long n, int threads) {
  const uint8_t* src = static_cast<const uint8_t*>(src_v);
  float* dst = static_cast<float*>(dst_v);
  if (threads <= 0) {
    threads = static_cast<int>(std::thread::hardware_concurrency());
    if (threads <= 0) threads = 1;
  }
  if (n < (1 << 18) || threads == 1) {
    convert_range(src, dst, 0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t b = t * per;
    int64_t e = b + per < n ? b + per : n;
    if (b >= e) break;
    pool.emplace_back(convert_range, src, dst, b, e);
  }
  for (auto& th : pool) th.join();
}

// Deinterleave uint8 IQ into separate float32 I and Q planes (for spectral
// tooling that wants planar data).
void iq_u8_split_f32(const void* src_v, void* i_v, void* q_v, long long n) {
  const uint8_t* src = static_cast<const uint8_t*>(src_v);
  float* di = static_cast<float*>(i_v);
  float* dq = static_cast<float*>(q_v);
  for (int64_t k = 0; k < n; ++k) {
    di[k] = static_cast<float>(src[2 * k]) - 127.5f;
    dq[k] = static_cast<float>(src[2 * k + 1]) - 127.5f;
  }
}

}  // extern "C"
