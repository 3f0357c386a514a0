// Pilosa-roaring <-> dense-tile codec (own copy of
// featurebase_tpu/native/roaring_codec.cpp).
//
// Native ingest/export hot path: parses the reference's roaring
// serialization (reference: roaring/roaring.go:19-51 cookie/header layout,
// WriteTo:1730, container types roaring.go:53-58) directly into dense
// 2^16-bit containers (2048 uint32 words) ready to be OR-ed into the host
// masters of the fragments,
// and encodes dense rows back into spec-compliant payloads (array/bitmap/run
// chosen by cardinality, mirroring Container.Optimize()).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).
//
// Built by native/gxx.py at first use: g++ -O3 -shared -fPIC, into
// featurebase_tpu_torch/build/ under a hash of this source.
#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr uint32_t kMagic = 12348;              // reference MagicNumber
constexpr size_t kHeaderBaseSize = 8;           // cookie(4) + keycount(4)
constexpr size_t kWordsPerContainer = 2048;     // 2^16 bits / 32
constexpr uint16_t kTypeArray = 1;
constexpr uint16_t kTypeBitmap = 2;
constexpr uint16_t kTypeRun = 3;
constexpr uint32_t kArrayMaxSize = 4096;        // reference ArrayMaxSize

inline uint16_t rd16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}
inline uint32_t rd32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}
inline uint64_t rd64(const uint8_t* p) {
  return static_cast<uint64_t>(rd32(p)) |
         (static_cast<uint64_t>(rd32(p + 4)) << 32);
}
inline void wr16(uint8_t* p, uint16_t v) {
  p[0] = v & 0xff;
  p[1] = v >> 8;
}
inline void wr32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xff;
  p[1] = (v >> 8) & 0xff;
  p[2] = (v >> 16) & 0xff;
  p[3] = (v >> 24) & 0xff;
}
inline void wr64(uint8_t* p, uint64_t v) {
  wr32(p, static_cast<uint32_t>(v));
  wr32(p + 4, static_cast<uint32_t>(v >> 32));
}

}  // namespace

extern "C" {

// Returns the number of containers in a pilosa-roaring payload, or -1 on
// malformed input.
long long roaring_container_count(const uint8_t* data, size_t len) {
  if (len == 0) return 0;
  if (len < kHeaderBaseSize) return -1;
  uint32_t cookie_word = rd32(data);
  uint32_t magic = cookie_word & 0xffff;
  uint32_t version = (cookie_word >> 16) & 0xff;
  if (magic != kMagic || version != 0) return -1;
  return static_cast<long long>(rd32(data + 4));
}

// Decodes a pilosa-roaring payload into dense containers.
//   keys_out:  n_containers uint64 container keys (bit-position >> 16)
//   bits_out:  n_containers * 2048 uint32 little-endian dense words
// Returns number of containers decoded, or -1 on malformed input / overflow
// of max_containers.
long long roaring_decode(const uint8_t* data, size_t len, uint64_t* keys_out,
                         uint32_t* bits_out, size_t max_containers) {
  long long n = roaring_container_count(data, len);
  if (n < 0) return -1;
  size_t nc = static_cast<size_t>(n);
  if (nc > max_containers) return -1;
  size_t header_end = kHeaderBaseSize + nc * 12;
  size_t offsets_end = header_end + nc * 4;
  if (len < offsets_end) return -1;

  for (size_t i = 0; i < nc; i++) {
    const uint8_t* hdr = data + kHeaderBaseSize + i * 12;
    uint64_t key = rd64(hdr);
    uint16_t typ = rd16(hdr + 8);
    uint32_t card = static_cast<uint32_t>(rd16(hdr + 10)) + 1;
    uint32_t off = rd32(data + header_end + i * 4);
    keys_out[i] = key;
    uint32_t* words = bits_out + i * kWordsPerContainer;
    std::memset(words, 0, kWordsPerContainer * sizeof(uint32_t));
    const uint8_t* p = data + off;
    switch (typ) {
      case kTypeArray: {
        if (off + card * 2 > len) return -1;
        for (uint32_t j = 0; j < card; j++) {
          uint16_t v = rd16(p + j * 2);
          words[v >> 5] |= (1u << (v & 31));
        }
        break;
      }
      case kTypeBitmap: {
        if (off + 8192 > len) return -1;
        std::memcpy(words, p, 8192);  // LE uint64[1024] == LE uint32[2048]
        break;
      }
      case kTypeRun: {
        if (off + 2 > len) return -1;
        uint16_t run_count = rd16(p);
        if (off + 2 + run_count * 4 > len) return -1;
        for (uint16_t r = 0; r < run_count; r++) {
          uint16_t start = rd16(p + 2 + r * 4);
          uint16_t last = rd16(p + 2 + r * 4 + 2);
          // set bits [start, last] inclusive
          uint32_t sw = start >> 5, lw = last >> 5;
          if (sw == lw) {
            uint32_t mask = (last - start == 31)
                                ? 0xffffffffu
                                : (((1u << (last - start + 1)) - 1)
                                   << (start & 31));
            words[sw] |= mask;
          } else {
            words[sw] |= ~0u << (start & 31);
            for (uint32_t w2 = sw + 1; w2 < lw; w2++) words[w2] = ~0u;
            words[lw] |= (last & 31) == 31
                             ? ~0u
                             : ((1u << ((last & 31) + 1)) - 1);
          }
        }
        break;
      }
      default:
        return -1;
    }
  }
  return static_cast<long long>(nc);
}

namespace {

inline int popcount32(uint32_t v) { return __builtin_popcount(v); }

// cardinality of a dense container
uint32_t container_card(const uint32_t* words) {
  uint32_t n = 0;
  for (size_t i = 0; i < kWordsPerContainer; i++) n += popcount32(words[i]);
  return n;
}

// number of runs in a dense container (for run-encoding decision;
// reference container.runs conversion heuristics): a run starts at each
// set bit whose lower neighbour (the previous word's top bit for bit 0)
// is clear, counted a word at a time
uint32_t container_runs(const uint32_t* words) {
  uint32_t runs = 0;
  uint32_t carry = 0;
  for (size_t i = 0; i < kWordsPerContainer; i++) {
    uint32_t w = words[i];
    runs += popcount32(w & ~((w << 1) | carry));
    carry = w >> 31;
  }
  return runs;
}

}  // namespace

// Computes the encoded size of a payload for the given dense containers.
// typ_out[i] receives the chosen container type.  Returns total byte size.
long long roaring_encoded_size(const uint32_t* bits, size_t n_containers,
                               uint16_t* typ_out, uint32_t* card_out) {
  size_t total = kHeaderBaseSize + n_containers * 16;
  for (size_t i = 0; i < n_containers; i++) {
    const uint32_t* words = bits + i * kWordsPerContainer;
    uint32_t card = container_card(words);
    uint32_t runs = container_runs(words);
    card_out[i] = card;
    // reference Optimize(): runs if 2+4*runs < min(2*card, 8192)
    size_t run_size = 2 + 4 * static_cast<size_t>(runs);
    size_t array_size = 2 * static_cast<size_t>(card);
    if (card == 0) {
      typ_out[i] = kTypeArray;
    } else if (run_size < array_size && run_size < 8192) {
      typ_out[i] = kTypeRun;
      total += run_size;
      continue;
    } else if (card <= kArrayMaxSize) {
      typ_out[i] = kTypeArray;
    } else {
      typ_out[i] = kTypeBitmap;
    }
    total += (typ_out[i] == kTypeArray) ? array_size : 8192;
  }
  return static_cast<long long>(total);
}

// Encodes dense containers into a pilosa-roaring payload.  `out` must have
// room for roaring_encoded_size() bytes.  Containers with zero cardinality
// are skipped (caller should pre-filter, but we guard anyway by writing them
// as empty arrays -- reference skips N()==0).  Returns bytes written.
long long roaring_encode(const uint64_t* keys, const uint32_t* bits,
                         size_t n_containers, uint8_t* out, size_t out_cap) {
  // first pass: types/cards/sizes
  uint16_t typs[65536];
  uint32_t cards[65536];
  if (n_containers > 65536) return -1;
  long long need = roaring_encoded_size(bits, n_containers, typs, cards);
  if (static_cast<size_t>(need) > out_cap) return -1;

  size_t live = 0;
  for (size_t i = 0; i < n_containers; i++)
    if (cards[i] > 0) live++;

  wr32(out, kMagic);  // cookie, no flags
  wr32(out + 4, static_cast<uint32_t>(live));
  size_t hdr = kHeaderBaseSize;
  size_t off_section = kHeaderBaseSize + live * 12;
  size_t data_off = kHeaderBaseSize + live * 16;
  size_t oi = 0;
  for (size_t i = 0; i < n_containers; i++) {
    if (cards[i] == 0) continue;
    const uint32_t* words = bits + i * kWordsPerContainer;
    wr64(out + hdr, keys[i]);
    wr16(out + hdr + 8, typs[i]);
    wr16(out + hdr + 10, static_cast<uint16_t>(cards[i] - 1));
    hdr += 12;
    wr32(out + off_section + oi * 4, static_cast<uint32_t>(data_off));
    oi++;
    uint8_t* p = out + data_off;
    if (typs[i] == kTypeArray) {
      size_t j = 0;
      for (uint32_t w = 0; w < kWordsPerContainer; w++) {
        uint32_t v = words[w];
        while (v) {
          int b = __builtin_ctz(v);
          wr16(p + j * 2, static_cast<uint16_t>(w * 32 + b));
          v &= v - 1;
          j++;
        }
      }
      data_off += j * 2;
    } else if (typs[i] == kTypeBitmap) {
      std::memcpy(p, words, 8192);
      data_off += 8192;
    } else {  // run
      uint16_t run_count = 0;
      size_t rc_pos = 0;  // patched later
      size_t j = 2;
      int start = -1;
      for (int v = 0; v < 65536; v++) {
        bool bit = (words[v >> 5] >> (v & 31)) & 1;
        if (bit && start < 0) start = v;
        if (!bit && start >= 0) {
          wr16(p + j, static_cast<uint16_t>(start));
          wr16(p + j + 2, static_cast<uint16_t>(v - 1));
          j += 4;
          run_count++;
          start = -1;
        }
      }
      if (start >= 0) {
        wr16(p + j, static_cast<uint16_t>(start));
        wr16(p + j + 2, 65535);
        j += 4;
        run_count++;
      }
      wr16(p + rc_pos, run_count);
      data_off += j;
    }
  }
  return static_cast<long long>(data_off);
}

}  // extern "C"
