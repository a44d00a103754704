// AMQP 0-9-1 frame scanner — native hot path for the wire codec.
//
// The port's own copy of the reference's native/framecodec.cc. The Python
// FrameParser (beholder_tpu_torch/mq/codec.py) walks the byte stream frame
// by frame in interpreted code; at high message rates (the service runs
// with prefetch 100) framing becomes the per-message fixed cost. This
// scanner locates all complete frames in a buffer in one C pass; Python
// then slices payloads zero-copy.
//
// Built at first use with the host C++ compiler (g++ -O2 -shared -fPIC ->
// libframecodec-<hash>.so under _build/ beside this file) and loaded via
// ctypes by beholder_tpu_torch/mq/_native.py.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {
constexpr uint8_t kFrameEnd = 0xCE;
constexpr size_t kHeaderSize = 7;  // type(1) + channel(2) + size(4)
}  // namespace

extern "C" {

// Scans `buf[0..len)` for complete AMQP frames.
//
// For each complete frame i (up to `max_frames`):
//   types[i]    = frame type octet
//   channels[i] = channel id
//   offsets[i]  = payload start offset into buf
//   sizes[i]    = payload size
//
// Returns the number of complete frames found (>= 0), or -1 if a frame-end
// octet is invalid (protocol error; *consumed points at the bad frame's
// start). *consumed is set to the number of bytes fully processed — the
// caller drops exactly that prefix and keeps the tail for the next feed.
int64_t amqp_scan_frames(const uint8_t* buf, int64_t len, int32_t* types,
                         int32_t* channels, int64_t* offsets, int64_t* sizes,
                         int64_t max_frames, int64_t* consumed) {
  int64_t pos = 0;
  int64_t count = 0;
  while (count < max_frames) {
    if (len - pos < static_cast<int64_t>(kHeaderSize)) break;
    const uint8_t type = buf[pos];
    const uint16_t channel =
        static_cast<uint16_t>(buf[pos + 1]) << 8 | buf[pos + 2];
    const uint32_t size = static_cast<uint32_t>(buf[pos + 3]) << 24 |
                          static_cast<uint32_t>(buf[pos + 4]) << 16 |
                          static_cast<uint32_t>(buf[pos + 5]) << 8 |
                          buf[pos + 6];
    const int64_t total = kHeaderSize + static_cast<int64_t>(size) + 1;
    if (len - pos < total) break;
    if (buf[pos + kHeaderSize + size] != kFrameEnd) {
      *consumed = pos;
      return -1;
    }
    types[count] = type;
    channels[count] = channel;
    offsets[count] = pos + kHeaderSize;
    sizes[count] = size;
    ++count;
    pos += total;
  }
  *consumed = pos;
  return count;
}

}  // extern "C"
