// TIFF-flavor LZW decoder (MSB-first bit packing, early code change).
//
// Fast path for the slide reader's tile decode loop (wsi/tiff.py): the
// pure-Python decoder holds the GIL and caps decode-thread scaling; this one
// releases it (called via ctypes) and runs ~50-100x faster.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Returns number of bytes written to out (<= out_cap), or -1 on error.
int64_t lzw_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_cap) {
  if (n <= 0) return 0;

  constexpr int32_t CLEAR = 256;
  constexpr int32_t EOI = 257;
  constexpr int32_t MAX_ENTRIES = 4096;

  // Table entries stored as (prefix, suffix) pairs; expand via stack.
  static thread_local std::vector<int32_t> prefix(MAX_ENTRIES);
  static thread_local std::vector<uint8_t> suffix(MAX_ENTRIES);
  static thread_local std::vector<uint8_t> stack(MAX_ENTRIES);

  int32_t next_code = 258;
  int bitlen = 9;
  int32_t maxcode = (1 << bitlen) - 2;  // early change threshold

  uint64_t buf = 0;
  int nbits = 0;
  int64_t pos = 0;
  int64_t out_pos = 0;
  int32_t prev = -1;

  auto emit_entry = [&](int32_t code, uint8_t* first_byte) -> bool {
    int sp = 0;
    int32_t c = code;
    while (c >= 258) {
      stack[sp++] = suffix[c];
      c = prefix[c];
      if (sp >= MAX_ENTRIES) return false;
    }
    stack[sp++] = static_cast<uint8_t>(c);
    *first_byte = static_cast<uint8_t>(c);
    // stack[sp-1] is the entry's FIRST byte; when the caller's buffer can't
    // hold the whole entry, emit a prefix of it (not the tail).
    int keep = sp;
    if (out_pos + keep > out_cap) keep = static_cast<int>(out_cap - out_pos);
    for (int i = 0; i < keep; ++i) out[out_pos++] = stack[sp - 1 - i];
    return true;
  };

  while (true) {
    while (nbits < bitlen) {
      if (pos >= n) return out_pos;
      buf = (buf << 8) | data[pos++];
      nbits += 8;
    }
    int32_t code = static_cast<int32_t>((buf >> (nbits - bitlen)) & ((1u << bitlen) - 1));
    nbits -= bitlen;

    if (code == EOI) break;
    if (code == CLEAR) {
      next_code = 258;
      bitlen = 9;
      maxcode = (1 << bitlen) - 2;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code > 255) return -1;
      if (out_pos < out_cap) out[out_pos++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    uint8_t first;
    if (code < next_code) {
      if (!emit_entry(code, &first)) return -1;
      if (next_code < MAX_ENTRIES) {
        prefix[next_code] = prev;
        suffix[next_code] = first;
        next_code++;
      }
    } else if (code == next_code) {
      // KwKwK case: entry = prev + first(prev)
      uint8_t first_prev;
      // find first byte of prev
      {
        int32_t c = prev;
        while (c >= 258) c = prefix[c];
        first_prev = static_cast<uint8_t>(c);
      }
      if (next_code < MAX_ENTRIES) {
        prefix[next_code] = prev;
        suffix[next_code] = first_prev;
        next_code++;
      }
      if (!emit_entry(code, &first)) return -1;
    } else {
      return -1;  // corrupt stream
    }
    prev = code;
    if (next_code >= maxcode && bitlen < 12) {
      bitlen++;
      maxcode = (1 << bitlen) - 2;
    }
    if (out_pos >= out_cap) return out_pos;
  }
  return out_pos;
}

// Horizontal-differencing predictor (TIFF predictor 2) undo, in place.
void predictor2_undo(uint8_t* data, int32_t height, int32_t width, int32_t samples) {
  for (int32_t r = 0; r < height; ++r) {
    uint8_t* row = data + static_cast<int64_t>(r) * width * samples;
    for (int64_t i = samples; i < static_cast<int64_t>(width) * samples; ++i) {
      row[i] = static_cast<uint8_t>(row[i] + row[i - samples]);
    }
  }
}

}  // extern "C"
