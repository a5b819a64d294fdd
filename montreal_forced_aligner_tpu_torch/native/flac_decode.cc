// Native FLAC frame decoder (hot loop of montreal_forced_aligner_tpu_torch.io.flac).
//
// The reference delegates audio decode to libsndfile (C); the package depends
// on no audio codec library, so it ships its own FLAC decoder. Bit-level Rice
// decoding and LPC prediction are far too slow in Python for corpus-scale
// audio (LibriSpeech is distributed as FLAC), so the frame-decoding loop is
// implemented here and loaded via ctypes. `io/flac.py` keeps the plain Python
// decoder with identical semantics; the tests hold the two against each
// other, and both are MD5-verified against STREAMINFO. Nothing falls back
// from one to the other: a short native decode raises.
//
// Built by g++ at first use through ops/cuda_build.py (SOURCES).

#include <cstdint>
#include <cstring>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos;
  int bit_pos;
  bool error;

  explicit BitReader(const uint8_t* d, size_t n, size_t pos)
      : data(d), size(n), byte_pos(pos), bit_pos(0), error(false) {}

  inline int read_bit() {
    if (byte_pos >= size) { error = true; return 0; }
    int b = (data[byte_pos] >> (7 - bit_pos)) & 1;
    if (++bit_pos == 8) { bit_pos = 0; ++byte_pos; }
    return b;
  }

  inline uint64_t read_uint(int bits) {
    uint64_t out = 0;
    while (bits > 0) {
      if (byte_pos >= size) { error = true; return 0; }
      if (bit_pos == 0 && bits >= 8) {
        out = (out << 8) | data[byte_pos++];
        bits -= 8;
      } else {
        int take = bits < (8 - bit_pos) ? bits : (8 - bit_pos);
        uint8_t cur = data[byte_pos];
        uint64_t val = (cur >> (8 - bit_pos - take)) & ((1u << take) - 1);
        out = (out << take) | val;
        bit_pos += take;
        if (bit_pos == 8) { bit_pos = 0; ++byte_pos; }
        bits -= take;
      }
    }
    return out;
  }

  inline int64_t read_int(int bits) {
    uint64_t v = read_uint(bits);
    if (bits > 0 && v >= (1ull << (bits - 1))) {
      return (int64_t)v - ((int64_t)1 << bits);
    }
    return (int64_t)v;
  }

  inline uint32_t read_unary() {
    uint32_t n = 0;
    for (;;) {
      if (byte_pos >= size) { error = true; return n; }
      if (bit_pos == 0) {
        while (byte_pos < size && data[byte_pos] == 0) { n += 8; ++byte_pos; }
        if (byte_pos >= size) { error = true; return n; }
      }
      if (read_bit()) return n;
      ++n;
    }
  }

  inline void align() {
    if (bit_pos) { bit_pos = 0; ++byte_pos; }
  }

  inline uint64_t read_utf8() {
    uint32_t first = (uint32_t)read_uint(8);
    if (first < 0x80) return first;
    int n_extra = 0;
    uint32_t mask = 0x40;
    while (first & mask) { ++n_extra; mask >>= 1; }
    uint64_t value = first & (mask - 1);
    for (int i = 0; i < n_extra; ++i) {
      value = (value << 6) | (read_uint(8) & 0x3F);
    }
    return value;
  }
};

const int kFixedOrders[5][4] = {
    {},
    {1},
    {2, -1},
    {3, -3, 1},
    {4, -6, 4, -1},
};

bool decode_residuals(BitReader& br, int block_size, int order, int64_t* out) {
  int method = (int)br.read_uint(2);
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  uint32_t escape = (1u << param_bits) - 1;
  int partition_order = (int)br.read_uint(4);
  int n_partitions = 1 << partition_order;
  int part_len = block_size >> partition_order;
  int idx = 0;
  for (int p = 0; p < n_partitions; ++p) {
    int count = part_len - (p == 0 ? order : 0);
    uint32_t param = (uint32_t)br.read_uint(param_bits);
    if (param == escape) {
      int bits = (int)br.read_uint(5);
      for (int i = 0; i < count; ++i) out[idx + i] = bits ? br.read_int(bits) : 0;
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint32_t r = param ? (uint32_t)br.read_uint(param) : 0;
        uint64_t v = (((uint64_t)q) << param) | r;
        out[idx + i] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
      }
    }
    idx += count;
    if (br.error) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int block_size, int bits_per_sample,
                     int64_t* samples, int64_t* resid_buf) {
  if (br.read_bit() != 0) return false;
  int sf_type = (int)br.read_uint(6);
  int wasted = 0;
  if (br.read_bit()) wasted = 1 + (int)br.read_unary();
  int bps = bits_per_sample - wasted;

  if (sf_type == 0) {  // constant
    int64_t v = br.read_int(bps);
    for (int i = 0; i < block_size; ++i) samples[i] = v;
  } else if (sf_type == 1) {  // verbatim
    for (int i = 0; i < block_size; ++i) samples[i] = br.read_int(bps);
  } else if (sf_type >= 8 && sf_type <= 12) {  // fixed
    int order = sf_type - 8;
    for (int i = 0; i < order; ++i) samples[i] = br.read_int(bps);
    if (!decode_residuals(br, block_size, order, resid_buf)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += kFixedOrders[order][j] * samples[i - 1 - j];
      samples[i] = resid_buf[i - order] + pred;
    }
  } else if (sf_type >= 32) {  // LPC
    int order = sf_type - 31;
    for (int i = 0; i < order; ++i) samples[i] = br.read_int(bps);
    int precision = (int)br.read_uint(4) + 1;
    int shift = (int)br.read_int(5);
    int64_t coeffs[32];
    for (int i = 0; i < order; ++i) coeffs[i] = br.read_int(precision);
    if (!decode_residuals(br, block_size, order, resid_buf)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coeffs[j] * samples[i - 1 - j];
      samples[i] = resid_buf[i - order] + (pred >> shift);
    }
  } else {
    return false;
  }
  if (wasted) {
    for (int i = 0; i < block_size; ++i) samples[i] <<= wasted;
  }
  return !br.error;
}

const int kBlockSizes[16] = {0,   192,  576,  1152, 2304, 4608, 0,    0,
                             256, 512,  1024, 2048, 4096, 8192, 16384, 32768};

}  // namespace

extern "C" {

// Decodes all frames starting at data[pos]; writes interleaved samples into
// out (int32, total_samples * num_channels). Returns samples written, or -1.
long long flac_decode_frames(const uint8_t* data, long long size,
                             long long pos, long long total_samples,
                             int num_channels, int bits_per_sample,
                             int32_t* out) {
  BitReader br(data, (size_t)size, (size_t)pos);
  long long written = 0;
  // scratch
  static thread_local int64_t* ch_buf[8] = {nullptr};
  static thread_local int64_t* resid = nullptr;
  static thread_local int buf_cap = 0;

  while (written < total_samples) {
    br.align();
    uint32_t sync = (uint32_t)br.read_uint(14);
    if (br.error) return -1;
    if (sync != 0x3FFE) return -2;
    br.read_bit();
    br.read_bit();
    int bs_code = (int)br.read_uint(4);
    int sr_code = (int)br.read_uint(4);
    int ch_code = (int)br.read_uint(4);
    br.read_uint(3);  // sample size code
    br.read_bit();
    br.read_utf8();
    int block_size;
    if (bs_code == 6) block_size = (int)br.read_uint(8) + 1;
    else if (bs_code == 7) block_size = (int)br.read_uint(16) + 1;
    else block_size = kBlockSizes[bs_code];
    if (block_size <= 0) return -3;
    if (sr_code == 12) br.read_uint(8);
    else if (sr_code == 13 || sr_code == 14) br.read_uint(16);
    br.read_uint(8);  // header CRC

    if (block_size > buf_cap) {
      for (int c = 0; c < 8; ++c) {
        delete[] ch_buf[c];
        ch_buf[c] = new int64_t[block_size];
      }
      delete[] resid;
      resid = new int64_t[block_size];
      buf_cap = block_size;
    }

    int channels = num_channels;
    if (ch_code < 8) {
      for (int c = 0; c < channels; ++c) {
        if (!decode_subframe(br, block_size, bits_per_sample, ch_buf[c], resid))
          return -4;
      }
    } else if (ch_code == 8) {  // left/side
      if (!decode_subframe(br, block_size, bits_per_sample, ch_buf[0], resid))
        return -4;
      if (!decode_subframe(br, block_size, bits_per_sample + 1, ch_buf[1], resid))
        return -4;
      for (int i = 0; i < block_size; ++i) ch_buf[1][i] = ch_buf[0][i] - ch_buf[1][i];
    } else if (ch_code == 9) {  // right/side
      if (!decode_subframe(br, block_size, bits_per_sample + 1, ch_buf[0], resid))
        return -4;
      if (!decode_subframe(br, block_size, bits_per_sample, ch_buf[1], resid))
        return -4;
      for (int i = 0; i < block_size; ++i) {
        int64_t side = ch_buf[0][i];
        int64_t right = ch_buf[1][i];
        ch_buf[0][i] = right + side;
      }
    } else if (ch_code == 10) {  // mid/side
      if (!decode_subframe(br, block_size, bits_per_sample, ch_buf[0], resid))
        return -4;
      if (!decode_subframe(br, block_size, bits_per_sample + 1, ch_buf[1], resid))
        return -4;
      for (int i = 0; i < block_size; ++i) {
        int64_t mid = ch_buf[0][i];
        int64_t side = ch_buf[1][i];
        int64_t left = (((mid << 1) | (side & 1)) + side) >> 1;
        ch_buf[0][i] = left;
        ch_buf[1][i] = left - side;
      }
    } else {
      return -5;
    }
    br.align();
    br.read_uint(16);  // frame CRC
    if (br.error) return -6;

    long long n = block_size;
    if (written + n > total_samples) n = total_samples - written;
    for (long long i = 0; i < n; ++i) {
      for (int c = 0; c < channels; ++c) {
        out[(written + i) * channels + c] = (int32_t)ch_buf[c][i];
      }
    }
    written += n;
  }
  return written;
}

}  // extern "C"
