// TIFF strip decoders (LZW, PackBits) for io/tiff.py.
//
// The same decoding as the pure-Python decoders there (`_lzw_decode`,
// `_unpackbits`), which stay as the plain versions: each stops once it has
// written `want` bytes or more, and may overshoot `want` by the rest of the
// last LZW table entry (at most 4096 bytes) or PackBits run (at most 128
// bytes), exactly where the Python loop does; `dst_cap` must leave room for
// that.  Built by g++ at first use and loaded with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// TIFF-variant LZW (MSB-first codes, early change).  Returns the bytes
// written, or -1 on a malformed strip (a code the table does not hold yet,
// or an output past dst_cap).
long lzw_decode(const uint8_t* src, long src_len, uint8_t* dst, long dst_cap, long want) {
  constexpr int kClear = 256, kEoi = 257;
  // table entries: (prev_code, suffix_byte, length); the first 256 are literals
  std::vector<int32_t> prev(4096), length(4096);
  std::vector<uint8_t> suffix(4096);
  for (int i = 0; i < 256; ++i) {
    prev[i] = -1;
    suffix[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int table_size = 258;

  auto emit = [&](int code, long pos) -> long {  // write the entry backwards
    const long len = length[code];
    if (pos + len > dst_cap) return -1;
    long p = pos + len - 1;
    for (int c = code; c >= 0; c = prev[c]) dst[p--] = suffix[c];
    return pos + len;
  };

  uint64_t bitbuf = 0;
  int bitcnt = 0, width = 9;
  int prev_code = -1;
  long out = 0, in = 0;
  while (out < want) {
    while (bitcnt < width) {
      if (in >= src_len) return out;
      bitbuf = (bitbuf << 8) | src[in++];
      bitcnt += 8;
    }
    const int code = static_cast<int>((bitbuf >> (bitcnt - width)) & ((1u << width) - 1));
    bitcnt -= width;
    if (code == kClear) {
      table_size = 258;
      width = 9;
      prev_code = -1;
      continue;
    }
    if (code == kEoi) break;
    if (prev_code < 0) {
      if (code >= 256) return -1;
      out = emit(code, out);
      if (out < 0) return -1;
      prev_code = code;
    } else {
      if (code > table_size) return -1;
      // the new entry: prev_code + the first byte of the code's entry (of
      // prev_code's own in the KwK case, code == table_size)
      int c = code < table_size ? code : prev_code;
      while (prev[c] >= 0) c = prev[c];
      const uint8_t first_byte = suffix[c];
      const bool kwk = code == table_size;
      if (table_size < 4096) {
        prev[table_size] = prev_code;
        suffix[table_size] = first_byte;
        length[table_size] = length[prev_code] + 1;
        ++table_size;
      }
      const int to_emit = kwk ? table_size - 1 : code;
      out = emit(to_emit, out);
      if (out < 0) return -1;
      prev_code = to_emit;
    }
    if (table_size >= (1 << width) - 1 && width < 12) ++width;
  }
  return out;
}

// PackBits.  Returns the bytes written; a run cut short by the end of the
// strip writes what the strip holds.
long packbits_decode(const uint8_t* src, long src_len, uint8_t* dst, long dst_cap, long want) {
  long in = 0, out = 0;
  while (in < src_len && out < want) {
    const uint8_t n = src[in++];
    if (n < 128) {
      const long c = std::min<long>(std::min<long>(n + 1, src_len - in), dst_cap - out);
      std::memcpy(dst + out, src + in, c);
      in += n + 1;
      out += c;
    } else if (n > 128) {
      if (in >= src_len) return out;
      const long c = std::min<long>(257 - n, dst_cap - out);
      std::memset(dst + out, src[in++], c);
      out += c;
    }  // n == 128: no-op
  }
  return out;
}

}  // extern "C"
