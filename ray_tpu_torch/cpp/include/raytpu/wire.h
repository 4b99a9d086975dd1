// Shared wire-framing primitives for the raytpu native protocol
// (ray_tpu_torch/_private/rpc.py): little-endian u32 length header (the
// Python side's struct '<I'), serialized explicitly so big-endian
// hosts speak the same bytes. Used by both the client (client.cpp)
// and the worker runtime (worker.cpp) — one copy, so a framing fix
// can never desynchronize the two.
#pragma once

#include <cstddef>
#include <cstdint>
#include <string>

namespace raytpu {
namespace wire {

constexpr uint8_t kWireVersion = 1;
constexpr int kReq = 0, kResp = 1, kErr = 2, kPush = 3;

inline void PutLe32(char* dst, uint32_t v) {
  dst[0] = static_cast<char>(v & 0xff);
  dst[1] = static_cast<char>((v >> 8) & 0xff);
  dst[2] = static_cast<char>((v >> 16) & 0xff);
  dst[3] = static_cast<char>((v >> 24) & 0xff);
}

inline uint32_t GetLe32(const char* src) {
  return static_cast<uint32_t>(static_cast<uint8_t>(src[0])) |
         (static_cast<uint32_t>(static_cast<uint8_t>(src[1])) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(src[2])) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(src[3])) << 24);
}

// All byte IO goes through Transport (transport.h) — raw-fd helpers
// were removed so nothing can silently bypass TLS.

}  // namespace wire
}  // namespace raytpu
