// COCO run-length encoding of binary masks, column-major (pycocotools'
// order): the JAX package's `arti3d_rle_encode` / `arti3d_rle_decode`
// (native/arti3d.cc), kept here as the port's own copy.
//
// Built with g++ by articulation3d_tpu_torch/native.py and loaded with
// ctypes; `utils/rle.py` calls it for every mask the evaluators encode or
// decode.

#include <cstdint>
#include <cstring>

extern "C" {

// Column-major RLE encode of an h*w uint8 mask (nonzero = 1). The first run
// counts zeros. counts must hold h*w + 1 entries. Returns the number of
// counts written.
int arti3d_rle_encode(const uint8_t* mask, int h, int w, uint32_t* counts) {
  int m = 0;
  uint8_t cur = 0;
  uint32_t run = 0;
  for (int64_t x = 0; x < w; ++x) {
    for (int64_t y = 0; y < h; ++y) {
      const uint8_t v = mask[y * w + x] ? 1 : 0;
      if (v == cur) {
        ++run;
      } else {
        counts[m++] = run;
        cur = v;
        run = 1;
      }
    }
  }
  counts[m++] = run;
  return m;
}

// Column-major RLE decode of m counts into an h*w uint8 mask; counts past
// h*w pixels are ignored.
void arti3d_rle_decode(const uint32_t* counts, int m, int h, int w,
                       uint8_t* mask) {
  std::memset(mask, 0, (size_t)h * w);
  int64_t pos = 0;
  uint8_t val = 0;
  for (int i = 0; i < m; ++i) {
    for (uint32_t c = 0; c < counts[i]; ++c) {
      if (pos >= (int64_t)h * w) return;
      if (val) {
        const int64_t x = pos / h;
        const int64_t y = pos % h;
        mask[y * w + x] = 1;
      }
      ++pos;
    }
    val ^= 1;
  }
}

}  // extern "C"
