// GIF LZW coder for the host CPU, loaded through ctypes by data/gif.py.
// This is host code standing in for PIL's GIF encoder, not a device kernel:
// LZW is serial.
//
// The coder writes one image's table-based image data as GIF89a stores it:
// the LZW minimum code size byte, the variable-length codes (LSB first) in
// sub-blocks of at most 255 bytes, and the zero-length block terminator.
// It starts with a clear code, widens codes when the next code to assign
// reaches 1 << width (up to 12 bits), sends a clear code and starts over
// when the 4096-entry table is full, and ends with the end-of-information
// code, widened first if the decoder, one entry behind, widens there.
//
// Interface (plain C; 0 on success, negative on error):
//   vt_gif_lzw(idx, n, min_code_size, out, cap, &len)
//     idx: n palette indices, each < 1 << min_code_size (2..8);
//     out: cap bytes; len: the bytes written.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxCodes = 4096;
constexpr int kHashSize = 8191;  // prime, twice the table

class BitWriter {
 public:
  BitWriter(uint8_t* out, int64_t cap) : out_(out), cap_(cap) {}

  bool put(uint32_t code, int width) {
    acc_ |= static_cast<uint64_t>(code) << nbits_;
    nbits_ += width;
    while (nbits_ >= 8) {
      if (!byte(static_cast<uint8_t>(acc_ & 0xff))) return false;
      acc_ >>= 8;
      nbits_ -= 8;
    }
    return true;
  }

  // flush the last partial byte and the open sub-block, then terminate
  bool finish() {
    if (nbits_ > 0 && !byte(static_cast<uint8_t>(acc_ & 0xff))) return false;
    acc_ = 0;
    nbits_ = 0;
    if (block_len_ > 0 && !close_block()) return false;
    if (pos_ >= cap_) return false;
    out_[pos_++] = 0;
    return true;
  }

  int64_t size() const { return pos_; }

 private:
  bool byte(uint8_t b) {
    if (block_len_ == 0) {  // reserve the sub-block's length byte
      if (pos_ >= cap_) return false;
      len_at_ = pos_++;
    }
    if (pos_ >= cap_) return false;
    out_[pos_++] = b;
    if (++block_len_ == 255) return close_block();
    return true;
  }

  bool close_block() {
    out_[len_at_] = static_cast<uint8_t>(block_len_);
    block_len_ = 0;
    return true;
  }

  uint8_t* out_;
  int64_t cap_;
  int64_t pos_ = 0;
  int64_t len_at_ = 0;
  int block_len_ = 0;
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

}  // namespace

extern "C" int vt_gif_lzw(const uint8_t* idx, int64_t n, int min_code_size,
                          uint8_t* out, int64_t cap, int64_t* out_len) {
  if (n <= 0 || min_code_size < 2 || min_code_size > 8 || cap < 2) return -1;
  const uint32_t clear = 1u << min_code_size;
  const uint32_t eoi = clear + 1;
  for (int64_t i = 0; i < n; ++i)
    if (idx[i] >= clear) return -2;

  // open addressing: key = prefix << 8 | byte, value = its code
  std::vector<int32_t> keys(kHashSize), codes(kHashSize);
  auto reset = [&]() { std::fill(keys.begin(), keys.end(), -1); };

  out[0] = static_cast<uint8_t>(min_code_size);
  BitWriter bw(out + 1, cap - 1);
  int width = min_code_size + 1;
  uint32_t next = eoi + 1;
  reset();
  if (!bw.put(clear, width)) return -3;

  uint32_t prefix = idx[0];
  for (int64_t i = 1; i < n; ++i) {
    const uint32_t c = idx[i];
    const int32_t key = static_cast<int32_t>((prefix << 8) | c);
    int h = static_cast<int>((static_cast<uint32_t>(key) * 2654435761u)
                             % kHashSize);
    while (keys[h] != -1 && keys[h] != key) h = (h + 1) % kHashSize;
    if (keys[h] == key) {
      prefix = static_cast<uint32_t>(codes[h]);
      continue;
    }
    if (!bw.put(prefix, width)) return -3;
    if (next < kMaxCodes) {
      if (next == (1u << width)) ++width;
      keys[h] = key;
      codes[h] = static_cast<int32_t>(next++);
    } else {  // table full: the decoder clears at this code too
      if (!bw.put(clear, width)) return -3;
      reset();
      width = min_code_size + 1;
      next = eoi + 1;
    }
    prefix = c;
  }
  if (!bw.put(prefix, width)) return -3;
  // the decoder adds an entry for the last code before it reads the next
  if (next < kMaxCodes && next == (1u << width)) ++width;
  if (!bw.put(eoi, width) || !bw.finish()) return -3;
  *out_len = bw.size() + 1;
  return 0;
}
