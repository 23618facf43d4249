// Marker-based priority-flood watershed, scikit-image-compatible semantics.
//
// The reference's instance extraction runs skimage.segmentation.watershed on
// 2048^2 tiles inside thread workers (reference: wsinsight/modellib/
// tilefuse.py:102,380-415). scikit-image is not a dependency here; this is the
// native hot path of the stitcher's finalize (a copy of the JAX package's
// native/watershed.cpp). Semantics match skimage
// watershed(image, markers, mask=...) with connectivity=1 (4-neighborhood),
// no compactness, no watershed lines:
//   * flood from marker pixels in increasing image value,
//   * ties broken by insertion order (age),
//   * pixels labeled when popped; each pixel takes the label of the source
//     that reached it first in (value, age) order.
//
// Built with the other native/*.cpp sources by ops/native_build.py.

#include <cstddef>
#include <cstdint>
#include <queue>
#include <vector>

namespace {

struct Entry {
  float value;
  uint32_t age;  // pushes are bounded by 2*n < 2^32 for any tile this sees
  int32_t idx;
  int32_t label;
};

struct Cmp {
  bool operator()(const Entry& a, const Entry& b) const {
    if (a.value != b.value) return a.value > b.value;  // min-heap on value
    return a.age > b.age;                              // FIFO within equal values
  }
};

}  // namespace

extern "C" {

// image: (H, W) float32; markers: (H, W) int32 (>0 = seed labels);
// mask: (H, W) uint8 (0 = excluded); out: (H, W) int32 result labels.
void watershed_f32(const float* image, const int32_t* markers,
                   const uint8_t* mask, int32_t height, int32_t width,
                   int32_t* out) {
  const int64_t n = static_cast<int64_t>(height) * width;
  std::priority_queue<Entry, std::vector<Entry>, Cmp> heap;
  uint32_t age = 0;

  for (int64_t i = 0; i < n; ++i) {
    if (mask != nullptr && mask[i] == 0) {
      out[i] = 0;
      continue;
    }
    out[i] = markers[i] > 0 ? markers[i] : 0;
  }

  const int32_t dr[4] = {-1, 1, 0, 0};
  const int32_t dc[4] = {0, 0, -1, 1};

  // Seed the heap with marker pixels (popped first, labeling neighbors) —
  // but only PRODUCTIVE ones: a marker pixel whose in-mask neighbors are all
  // labeled at init can never label anything when popped (labels are only
  // ever set, never cleared), so skipping it is exact. Marker interiors are
  // the bulk of the seed mass; seeding just the boundary ring keeps the heap
  // a fraction of the size. Ages stay raster-ordered among the survivors, so
  // equal-value tie-breaking is unchanged.
  for (int64_t i = 0; i < n; ++i) {
    if (out[i] <= 0 || (mask != nullptr && mask[i] == 0)) continue;
    const int32_t r = static_cast<int32_t>(i / width);
    const int32_t c = static_cast<int32_t>(i % width);
    bool productive = false;
    for (int k = 0; k < 4 && !productive; ++k) {
      const int32_t rr = r + dr[k];
      const int32_t cc = c + dc[k];
      if (rr < 0 || rr >= height || cc < 0 || cc >= width) continue;
      const int64_t j = static_cast<int64_t>(rr) * width + cc;
      if (mask != nullptr && mask[j] == 0) continue;
      productive = out[j] == 0;
    }
    if (productive) {
      heap.push(Entry{image[i], age++, static_cast<int32_t>(i), out[i]});
    }
  }

  while (!heap.empty()) {
    Entry e = heap.top();
    heap.pop();
    const int32_t r = e.idx / width;
    const int32_t c = e.idx % width;
    for (int k = 0; k < 4; ++k) {
      const int32_t rr = r + dr[k];
      const int32_t cc = c + dc[k];
      if (rr < 0 || rr >= height || cc < 0 || cc >= width) continue;
      const int64_t j = static_cast<int64_t>(rr) * width + cc;
      if (mask != nullptr && mask[j] == 0) continue;
      if (out[j] != 0) continue;
      out[j] = e.label;
      heap.push(Entry{image[j], age++, static_cast<int32_t>(j), e.label});
    }
  }
}

// Remove labeled objects smaller than min_size (4-connectivity labels given).
// labels: (H, W) int32 modified in place; max_label: highest label id.
void remove_small_labels(int32_t* labels, int32_t height, int32_t width,
                         int32_t max_label, int32_t min_size) {
  const int64_t n = static_cast<int64_t>(height) * width;
  std::vector<int64_t> counts(static_cast<size_t>(max_label) + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t v = labels[i];
    if (v > 0 && v <= max_label) counts[v]++;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int32_t v = labels[i];
    if (v > 0 && v <= max_label && counts[v] < min_size) labels[i] = 0;
  }
}

}  // extern "C"
