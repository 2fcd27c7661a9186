// Wire-compression codecs for the cross-host chunk ring (docs/compression.md).
//
// Four codecs, all fp32-in / fp32-out with full-precision accumulation on
// the receive side (the ring never adds quantized values together):
//
//  - bf16: truncate each fp32 to its high 16 bits.  The exponent field is
//    copied exactly, so no bf16-encodable magnitude can overflow; values
//    already representable in bf16 round-trip bit-exactly.
//  - int8: per-256-element block scale (EQuARX-style).  Block layout on the
//    wire is [4-byte little-endian fp32 scale][one int8 per element]; the
//    last block of a tensor may be short.  scale = max|x|/127, so the
//    per-element error is bounded by scale/2 (round-to-nearest).
//  - int4: the same 256-element block scale with 4-bit codes, two per byte
//    (element 2i in the low nibble, 2i+1 in the high nibble).  scale =
//    max|x|/7; per-element error bounded by scale/2.  ~0.13x the raw bytes.
//  - int8g: two-level scales (EQuARX's dynamic block scaling).  One fp32
//    scale per 4096-element GROUP (kWireGroup) plus one uint8 sub-scale
//    per 256-element block: group scale = max|group|/127, sub-scale byte
//    s = min(255, nearbyint(max|block|/max|group| * kWireSubDenom)),
//    effective block scale = group_scale * s/kWireSubDenom.  The sub-scale
//    denominator is a power of two (256) on purpose: scaling by 2^-8
//    commutes exactly with fp32 rounding, so the effective scale is
//    bit-identical no matter how encoder/decoder (or a compiled traced
//    mirror) associate the multiply — required for cross-rank bit-identity
//    when encoded bytes are forwarded verbatim.  Group layout on the wire
//    is [4-byte fp32 group scale][one sub-scale byte per block][one int8
//    code per element].  Fine-grained per-block scaling at ~1/4 of int8's
//    scale overhead.
//
// The encoded stream is position-independent per element: byte offsets are
// pure functions of the element index, so a receiver can decode any prefix
// of elements as chunks arrive (WireDecodableElems / WireDecodeRange) and
// the allgather phase can forward encoded bytes verbatim for cross-rank
// bit-identity.
//
// Shared edge semantics for every block-scaled codec: the max|x| scan uses
// `a > maxabs`, so NaN elements never win (an all-NaN block/group keeps
// scale 0 and encodes zeros); a block/group whose max is inf stores a
// non-finite scale with zero codes (decode yields NaN via inf*0 rather
// than inventing values); a NaN element inside an otherwise-finite block
// clamps to the positive code bound (std::min/std::max operand order).
//
// Header-only so the selftests link it without extra objects.

#ifndef HVD_TPU_WIRE_CODEC_H_
#define HVD_TPU_WIRE_CODEC_H_

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace hvdtpu {

enum class WireCodec : int32_t {
  kNone = 0,
  kBf16 = 1,
  kInt8 = 2,
  kInt4 = 3,
  kInt8g = 4,
};

// Block geometry: one scale record per 256 elements (int8/int4), one fp32
// group scale per 4096 elements with uint8 sub-scales (int8g), 4-bit codes
// clamp to +/-kWireInt4Max.  Mirrored as traced math by
// horovod_tpu/ops/quantize.py (WIRE_BLOCK / WIRE_SCALE_BYTES / WIRE_GROUP /
// WIRE_INT4_MAX / WIRE_CODEC_IDS) for the device-plane quantized ring;
// tools/hvd_lint.py enforces the two stay in sync.
constexpr int64_t kWireBlock = 256;
constexpr int64_t kWireScaleBytes = 4;
constexpr int64_t kWireGroup = 4096;
constexpr int64_t kWireInt4Max = 7;
constexpr int64_t kWireSubDenom = 256;

// Encoded size in bytes of `count` fp32 elements under `codec`.
inline int64_t WireEncodedBytes(WireCodec codec, int64_t count) {
  switch (codec) {
    case WireCodec::kBf16:
      return 2 * count;
    case WireCodec::kInt8: {
      const int64_t blocks = (count + kWireBlock - 1) / kWireBlock;
      return blocks * kWireScaleBytes + count;
    }
    case WireCodec::kInt4: {
      const int64_t blocks = (count + kWireBlock - 1) / kWireBlock;
      return blocks * kWireScaleBytes + (count + 1) / 2;
    }
    case WireCodec::kInt8g: {
      const int64_t groups = (count + kWireGroup - 1) / kWireGroup;
      const int64_t blocks = (count + kWireBlock - 1) / kWireBlock;
      return groups * kWireScaleBytes + blocks + count;
    }
    case WireCodec::kNone:
    default:
      return 4 * count;
  }
}

namespace wire_internal {

// NaN-proof max|x| over [src, src+n): `a > maxabs` never lets NaN win.
inline float MaxAbs(const float* src, int64_t n) {
  float maxabs = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    const float a = std::fabs(src[i]);
    if (a > maxabs) maxabs = a;
  }
  return maxabs;
}

}  // namespace wire_internal

// Encode `count` fp32 elements from `src` into `dst`
// (WireEncodedBytes(codec, count) bytes).
inline void WireEncode(WireCodec codec, const float* src, int64_t count,
                       char* dst) {
  if (codec == WireCodec::kBf16) {
    uint16_t* out = reinterpret_cast<uint16_t*>(dst);
    for (int64_t i = 0; i < count; ++i) {
      uint32_t bits;
      std::memcpy(&bits, src + i, 4);
      out[i] = static_cast<uint16_t>(bits >> 16);
    }
    return;
  }
  if (codec == WireCodec::kInt8) {
    for (int64_t b0 = 0; b0 < count; b0 += kWireBlock) {
      const int64_t n = std::min(kWireBlock, count - b0);
      const float maxabs = wire_internal::MaxAbs(src + b0, n);
      const float scale = maxabs / 127.0f;
      std::memcpy(dst, &scale, kWireScaleBytes);
      int8_t* q = reinterpret_cast<int8_t*>(dst + kWireScaleBytes);
      if (scale > 0.0f && std::isfinite(scale)) {
        const float inv = 1.0f / scale;
        for (int64_t i = 0; i < n; ++i) {
          const float v = std::nearbyintf(src[b0 + i] * inv);
          q[i] = static_cast<int8_t>(
              std::max(-127.0f, std::min(127.0f, v)));
        }
      } else {
        // All-zero block (or non-finite scale from inf/nan input: encode
        // zeros rather than propagate garbage — matching the clamp above).
        std::memset(q, 0, static_cast<size_t>(n));
      }
      dst += kWireScaleBytes + n;
    }
    return;
  }
  if (codec == WireCodec::kInt4) {
    const float qmax = static_cast<float>(kWireInt4Max);
    for (int64_t b0 = 0; b0 < count; b0 += kWireBlock) {
      const int64_t n = std::min(kWireBlock, count - b0);
      const float maxabs = wire_internal::MaxAbs(src + b0, n);
      const float scale = maxabs / qmax;
      std::memcpy(dst, &scale, kWireScaleBytes);
      uint8_t* q = reinterpret_cast<uint8_t*>(dst + kWireScaleBytes);
      const int64_t nbytes = (n + 1) / 2;
      if (scale > 0.0f && std::isfinite(scale)) {
        const float inv = 1.0f / scale;
        std::memset(q, 0, static_cast<size_t>(nbytes));
        for (int64_t i = 0; i < n; ++i) {
          const float v = std::nearbyintf(src[b0 + i] * inv);
          const int code = static_cast<int>(std::max(-qmax, std::min(qmax, v)));
          const uint8_t nib = static_cast<uint8_t>(code) & 0x0F;
          q[i / 2] |= (i & 1) ? static_cast<uint8_t>(nib << 4) : nib;
        }
      } else {
        std::memset(q, 0, static_cast<size_t>(nbytes));
      }
      dst += kWireScaleBytes + nbytes;
    }
    return;
  }
  if (codec == WireCodec::kInt8g) {
    for (int64_t g0 = 0; g0 < count; g0 += kWireGroup) {
      const int64_t gn = std::min(kWireGroup, count - g0);
      const int64_t nblk = (gn + kWireBlock - 1) / kWireBlock;
      const float gmax = wire_internal::MaxAbs(src + g0, gn);
      const float gscale = gmax / 127.0f;
      std::memcpy(dst, &gscale, kWireScaleBytes);
      uint8_t* sub = reinterpret_cast<uint8_t*>(dst + kWireScaleBytes);
      int8_t* q = reinterpret_cast<int8_t*>(dst + kWireScaleBytes + nblk);
      if (gscale > 0.0f && std::isfinite(gscale)) {
        for (int64_t b = 0; b < nblk; ++b) {
          const int64_t b0 = b * kWireBlock;
          const int64_t n = std::min(kWireBlock, gn - b0);
          const float bmax = wire_internal::MaxAbs(src + g0 + b0, n);
          // bmax <= gmax, so the ratio is in [0, 1]; the block holding
          // gmax rounds to kWireSubDenom and clamps to 255 (its max
          // element still encodes as code 127 after round).
          const float ratio = bmax / gmax;
          const uint8_t s = static_cast<uint8_t>(std::min(
              255.0f,
              std::nearbyintf(ratio * static_cast<float>(kWireSubDenom))));
          sub[b] = s;
          if (s > 0) {
            const float eff =
                gscale * (static_cast<float>(s) /
                          static_cast<float>(kWireSubDenom));
            const float inv = 1.0f / eff;
            for (int64_t i = 0; i < n; ++i) {
              const float v = std::nearbyintf(src[g0 + b0 + i] * inv);
              q[b0 + i] = static_cast<int8_t>(
                  std::max(-127.0f, std::min(127.0f, v)));
            }
          } else {
            // All-zero / all-NaN block inside a finite group, or a block
            // whose max rounds below the sub-scale resolution: codes 0.
            std::memset(q + b0, 0, static_cast<size_t>(n));
          }
        }
      } else {
        std::memset(sub, 0, static_cast<size_t>(nblk));
        std::memset(q, 0, static_cast<size_t>(gn));
      }
      dst += kWireScaleBytes + nblk + gn;
    }
    return;
  }
  std::memcpy(dst, src, static_cast<size_t>(4 * count));
}

// Decode elements [elem_lo, elem_hi) of an encoded stream that carries
// `count` elements total.  `src` points at the START of the encoded stream
// (not at elem_lo); `dst` receives elem_hi - elem_lo fp32 values.
inline void WireDecodeRange(WireCodec codec, const char* src, int64_t count,
                            int64_t elem_lo, int64_t elem_hi, float* dst) {
  if (codec == WireCodec::kBf16) {
    const uint16_t* in = reinterpret_cast<const uint16_t*>(src) + elem_lo;
    for (int64_t i = 0; i < elem_hi - elem_lo; ++i) {
      const uint32_t bits = static_cast<uint32_t>(in[i]) << 16;
      std::memcpy(dst + i, &bits, 4);
    }
    return;
  }
  if (codec == WireCodec::kInt8) {
    for (int64_t e = elem_lo; e < elem_hi;) {
      const int64_t blk = e / kWireBlock;
      const int64_t in_blk = e % kWireBlock;
      const int64_t blk_end = std::min((blk + 1) * kWireBlock, elem_hi);
      const char* base =
          src + blk * (kWireScaleBytes + kWireBlock) + kWireScaleBytes;
      float scale;
      std::memcpy(&scale,
                  src + blk * (kWireScaleBytes + kWireBlock), 4);
      const int8_t* q = reinterpret_cast<const int8_t*>(base) + in_blk;
      for (int64_t i = 0; e + i < blk_end; ++i) {
        dst[e + i - elem_lo] = scale * static_cast<float>(q[i]);
      }
      e = blk_end;
    }
    return;
  }
  if (codec == WireCodec::kInt4) {
    const int64_t per_block = kWireScaleBytes + kWireBlock / 2;
    for (int64_t e = elem_lo; e < elem_hi;) {
      const int64_t blk = e / kWireBlock;
      const int64_t blk_end = std::min((blk + 1) * kWireBlock, elem_hi);
      float scale;
      std::memcpy(&scale, src + blk * per_block, 4);
      const uint8_t* q = reinterpret_cast<const uint8_t*>(
          src + blk * per_block + kWireScaleBytes);
      for (int64_t i = e; i < blk_end; ++i) {
        const int64_t in_blk = i % kWireBlock;
        const uint8_t b = q[in_blk / 2];
        const int nib = (in_blk & 1) ? (b >> 4) & 0x0F : b & 0x0F;
        // Sign-extend the nibble: [-8, 7] (codes only use [-7, 7]).
        const int code = (nib ^ 8) - 8;
        dst[i - elem_lo] = scale * static_cast<float>(code);
      }
      e = blk_end;
    }
    return;
  }
  if (codec == WireCodec::kInt8g) {
    for (int64_t e = elem_lo; e < elem_hi;) {
      const int64_t grp = e / kWireGroup;
      const int64_t g0 = grp * kWireGroup;
      const int64_t gn = std::min(kWireGroup, count - g0);
      const int64_t nblk = (gn + kWireBlock - 1) / kWireBlock;
      const int64_t grp_end = std::min(g0 + gn, elem_hi);
      // Only the LAST group of a stream may be short, so full-group
      // offsets stay pure functions of the element index.
      const char* base = src + grp * (kWireScaleBytes + kWireGroup / kWireBlock +
                                      kWireGroup);
      float gscale;
      std::memcpy(&gscale, base, 4);
      const uint8_t* sub =
          reinterpret_cast<const uint8_t*>(base + kWireScaleBytes);
      const int8_t* q =
          reinterpret_cast<const int8_t*>(base + kWireScaleBytes + nblk);
      for (int64_t i = e; i < grp_end; ++i) {
        const int64_t ig = i - g0;
        const float eff =
            gscale * (static_cast<float>(sub[ig / kWireBlock]) /
                      static_cast<float>(kWireSubDenom));
        dst[i - elem_lo] = eff * static_cast<float>(q[ig]);
      }
      e = grp_end;
    }
    return;
  }
  (void)count;
  std::memcpy(dst, src + 4 * elem_lo,
              static_cast<size_t>(4 * (elem_hi - elem_lo)));
}

// How many leading elements of a `total_elems`-element encoded stream are
// fully decodable once `bytes_received` prefix bytes have arrived.  Used by
// the ring's incremental consume path (chunk boundaries are byte-, not
// block-aligned).
inline int64_t WireDecodableElems(WireCodec codec, int64_t bytes_received,
                                  int64_t total_elems) {
  int64_t n;
  switch (codec) {
    case WireCodec::kBf16:
      n = bytes_received / 2;
      break;
    case WireCodec::kInt8: {
      const int64_t per_block = kWireScaleBytes + kWireBlock;
      const int64_t full = bytes_received / per_block;
      const int64_t rem = bytes_received % per_block;
      n = full * kWireBlock +
          std::max<int64_t>(0, rem - kWireScaleBytes);
      break;
    }
    case WireCodec::kInt4: {
      const int64_t per_block = kWireScaleBytes + kWireBlock / 2;
      const int64_t full = bytes_received / per_block;
      const int64_t rem = bytes_received % per_block;
      n = full * kWireBlock +
          std::max<int64_t>(0, (rem - kWireScaleBytes) * 2);
      break;
    }
    case WireCodec::kInt8g: {
      const int64_t per_group =
          kWireScaleBytes + kWireGroup / kWireBlock + kWireGroup;
      const int64_t full_groups = total_elems / kWireGroup;
      if (bytes_received >= full_groups * per_group) {
        // The prefix covers every complete group; the remainder lands in
        // the short tail group, whose header carries only as many
        // sub-scale bytes as it has blocks.
        const int64_t tail = total_elems - full_groups * kWireGroup;
        const int64_t nblk = (tail + kWireBlock - 1) / kWireBlock;
        const int64_t rem = bytes_received - full_groups * per_group;
        n = full_groups * kWireGroup +
            std::max<int64_t>(0, rem - (kWireScaleBytes + nblk));
      } else {
        const int64_t header = kWireScaleBytes + kWireGroup / kWireBlock;
        const int64_t full = bytes_received / per_group;
        const int64_t rem = bytes_received % per_group;
        n = full * kWireGroup + std::max<int64_t>(0, rem - header);
      }
      break;
    }
    case WireCodec::kNone:
    default:
      n = bytes_received / 4;
      break;
  }
  return std::min(n, total_elems);
}

}  // namespace hvdtpu

#endif  // HVD_TPU_WIRE_CODEC_H_
