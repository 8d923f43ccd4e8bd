// apex_tpu_torch native host helpers (the `apex_C` extension analog).
//
// Capability match of the reference's C++ runtime pieces:
//  - flatten/unflatten of tensor lists (reference:
//    csrc/flatten_unflatten.cpp:15-17, used by DDP's flat buckets)
//  - the bucket planner behind DDP's first-iteration bucket-structure
//    discovery (reference: apex/parallel/distributed.py:320-409), here a
//    deterministic greedy size-capped planner
//
// Compiled on first use with the host C++ compiler (no torch/pybind
// dependency): a plain C ABI over contiguous host buffers, driven from
// Python through ctypes.  The hot paths are parallel memcpy loops over
// the byte views of host tensors; they feed checkpoint serialization,
// where Python-loop copies would be the bottleneck.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Copy n buffers (sizes[i] bytes each) into one contiguous dst.
// Parallelized across `threads` workers over buffer boundaries.
void apex_c_flatten(const void** srcs, const int64_t* nbytes, int64_t n,
                    void* dst, int32_t threads) {
  std::vector<int64_t> offsets(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) offsets[i + 1] = offsets[i] + nbytes[i];
  if (threads < 1) threads = 1;
  auto worker = [&](int32_t w) {
    for (int64_t i = w; i < n; i += threads) {
      std::memcpy(static_cast<char*>(dst) + offsets[i], srcs[i],
                  static_cast<size_t>(nbytes[i]));
    }
  };
  if (threads == 1 || n == 1) {
    worker(0);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int32_t w = 0; w < threads; ++w) pool.emplace_back(worker, w);
  for (auto& t : pool) t.join();
}

// Inverse: split one contiguous src back into n buffers.
void apex_c_unflatten(const void* src, void** dsts, const int64_t* nbytes,
                      int64_t n, int32_t threads) {
  std::vector<int64_t> offsets(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) offsets[i + 1] = offsets[i] + nbytes[i];
  if (threads < 1) threads = 1;
  auto worker = [&](int32_t w) {
    for (int64_t i = w; i < n; i += threads) {
      std::memcpy(dsts[i], static_cast<const char*>(src) + offsets[i],
                  static_cast<size_t>(nbytes[i]));
    }
  };
  if (threads == 1 || n == 1) {
    worker(0);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int32_t w = 0; w < threads; ++w) pool.emplace_back(worker, w);
  for (auto& t : pool) t.join();
}

// Greedy size-capped bucketing: walk tensors in order, start a new
// bucket when adding one would exceed cap_bytes (a lone oversized
// tensor still gets its own bucket).  Writes bucket ids and returns the
// bucket count.
int64_t apex_c_plan_buckets(const int64_t* nbytes, int64_t n,
                            int64_t cap_bytes, int32_t* bucket_ids) {
  int64_t bucket = 0, used = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (used > 0 && used + nbytes[i] > cap_bytes) {
      ++bucket;
      used = 0;
    }
    bucket_ids[i] = static_cast<int32_t>(bucket);
    used += nbytes[i];
  }
  return n > 0 ? bucket + 1 : 0;
}

}  // extern "C"
