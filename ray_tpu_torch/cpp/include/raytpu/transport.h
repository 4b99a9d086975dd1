// Byte transport for the raytpu native protocol: a plain TCP socket,
// or TLS with the cluster's pinned self-signed certificate.
//
// TLS matches the Python client's posture (ray_tpu_torch/_private/rpc.py
// _ssl_client_ctx): the cluster cert is the SOLE trust root
// (verify-peer against it; hostname irrelevant — any server holding
// the matching key is the cluster). The image ships OpenSSL 3 runtime
// libraries but no headers, so tls.cpp binds the needed functions from
// libssl.so.3 via dlopen against the stable C ABI — the same
// load-at-runtime approach the Python ssl module ultimately uses.
#pragma once

#include <memory>
#include <stdexcept>
#include <string>

namespace raytpu {

// Transport-level failure (peer unreachable / connection dropped):
// retryable by ReconnectingClient, unlike protocol errors.
class ConnectionError : public std::runtime_error {
 public:
  using std::runtime_error::runtime_error;
};

class Transport {
 public:
  virtual ~Transport() = default;
  // Full-buffer IO; throw ConnectionError on EOF/failure.
  virtual void WriteAll(const char* data, size_t n) = 0;
  virtual void ReadAll(char* data, size_t n) = 0;

  // cert_path empty = plaintext TCP. Throws ConnectionError when the
  // peer is unreachable, std::runtime_error for TLS setup/verification
  // failures (wrong cert = not retryable).
  static std::unique_ptr<Transport> Connect(const std::string& host,
                                            int port,
                                            const std::string& cert_path);

  // Server side over an accepted fd: with a cert+key, runs the TLS
  // handshake (the worker runtime's listener in a --tls cluster).
  static std::unique_ptr<Transport> Accept(int fd,
                                           const std::string& cert_path,
                                           const std::string& key_path);
};

}  // namespace raytpu
