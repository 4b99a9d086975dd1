// See transport.h. TLS binds libssl.so.3 / libcrypto.so.3 at runtime
// (no OpenSSL headers in the image); only stable OpenSSL 3 C-ABI
// entry points are used.

#include "raytpu/transport.h"

#include <dlfcn.h>
#include <netdb.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstring>
#include <mutex>

namespace raytpu {
namespace {

int DialTcp(const std::string& host, int port) {
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  std::string port_s = std::to_string(port);
  if (getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) != 0 || !res)
    throw ConnectionError("raytpu: cannot resolve " + host);
  int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0 || ::connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    freeaddrinfo(res);
    if (fd >= 0) ::close(fd);
    throw ConnectionError("raytpu: cannot connect to " + host + ":" +
                          port_s);
  }
  freeaddrinfo(res);
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

class PlainTransport : public Transport {
 public:
  explicit PlainTransport(int fd) : fd_(fd) {}
  ~PlainTransport() override {
    if (fd_ >= 0) ::close(fd_);
  }
  void WriteAll(const char* data, size_t n) override {
    while (n > 0) {
      // MSG_NOSIGNAL: a peer that vanished mid-write must surface as
      // ConnectionError (ReconnectingClient's retry signal), not
      // SIGPIPE-kill the process.
      ssize_t w = ::send(fd_, data, n, MSG_NOSIGNAL);
      if (w <= 0) throw ConnectionError("raytpu: connection write failed");
      data += w;
      n -= static_cast<size_t>(w);
    }
  }
  void ReadAll(char* data, size_t n) override {
    while (n > 0) {
      ssize_t r = ::read(fd_, data, n);
      if (r <= 0) throw ConnectionError("raytpu: connection closed");
      data += r;
      n -= static_cast<size_t>(r);
    }
  }

 private:
  int fd_;
};

// ---- OpenSSL 3 ABI, bound at runtime ---------------------------------
struct SslApi {
  // Opaque handles; the ABI passes pointers only.
  using SSL_CTX = void;
  using SSL = void;
  using SSL_METHOD = void;

  const SSL_METHOD* (*TLS_client_method)();
  const SSL_METHOD* (*TLS_server_method)();
  int (*SSL_CTX_use_certificate_chain_file)(SSL_CTX*, const char*);
  int (*SSL_CTX_use_PrivateKey_file)(SSL_CTX*, const char*, int);
  int (*SSL_accept)(SSL*);
  SSL_CTX* (*SSL_CTX_new)(const SSL_METHOD*);
  void (*SSL_CTX_free)(SSL_CTX*);
  int (*SSL_CTX_load_verify_locations)(SSL_CTX*, const char*, const char*);
  void (*SSL_CTX_set_verify)(SSL_CTX*, int, void*);
  SSL* (*SSL_new)(SSL_CTX*);
  void (*SSL_free)(SSL*);
  int (*SSL_set_fd)(SSL*, int);
  int (*SSL_connect)(SSL*);
  int (*SSL_read)(SSL*, void*, int);
  int (*SSL_write)(SSL*, const void*, int);
  int (*SSL_shutdown)(SSL*);
  long (*SSL_get_verify_result)(const SSL*);

  static const SslApi& Get() {
    static SslApi api = Load();
    return api;
  }

 private:
  static SslApi Load() {
    void* ssl = dlopen("libssl.so.3", RTLD_NOW | RTLD_GLOBAL);
    if (!ssl) ssl = dlopen("libssl.so", RTLD_NOW | RTLD_GLOBAL);
    if (!ssl)
      throw std::runtime_error(
          "raytpu: TLS requested but libssl.so.3 is not loadable");
    SslApi api{};
    auto bind = [&](const char* name) -> void* {
      void* fn = dlsym(ssl, name);
      if (!fn)
        throw std::runtime_error(
            std::string("raytpu: libssl is missing ") + name);
      return fn;
    };
    api.TLS_client_method = reinterpret_cast<const SSL_METHOD* (*)()>(
        bind("TLS_client_method"));
    api.TLS_server_method = reinterpret_cast<const SSL_METHOD* (*)()>(
        bind("TLS_server_method"));
    api.SSL_CTX_use_certificate_chain_file =
        reinterpret_cast<int (*)(SSL_CTX*, const char*)>(
            bind("SSL_CTX_use_certificate_chain_file"));
    api.SSL_CTX_use_PrivateKey_file =
        reinterpret_cast<int (*)(SSL_CTX*, const char*, int)>(
            bind("SSL_CTX_use_PrivateKey_file"));
    api.SSL_accept =
        reinterpret_cast<int (*)(SSL*)>(bind("SSL_accept"));
    api.SSL_CTX_new = reinterpret_cast<SSL_CTX* (*)(const SSL_METHOD*)>(
        bind("SSL_CTX_new"));
    api.SSL_CTX_free =
        reinterpret_cast<void (*)(SSL_CTX*)>(bind("SSL_CTX_free"));
    api.SSL_CTX_load_verify_locations =
        reinterpret_cast<int (*)(SSL_CTX*, const char*, const char*)>(
            bind("SSL_CTX_load_verify_locations"));
    api.SSL_CTX_set_verify =
        reinterpret_cast<void (*)(SSL_CTX*, int, void*)>(
            bind("SSL_CTX_set_verify"));
    api.SSL_new = reinterpret_cast<SSL* (*)(SSL_CTX*)>(bind("SSL_new"));
    api.SSL_free = reinterpret_cast<void (*)(SSL*)>(bind("SSL_free"));
    api.SSL_set_fd =
        reinterpret_cast<int (*)(SSL*, int)>(bind("SSL_set_fd"));
    api.SSL_connect =
        reinterpret_cast<int (*)(SSL*)>(bind("SSL_connect"));
    api.SSL_read =
        reinterpret_cast<int (*)(SSL*, void*, int)>(bind("SSL_read"));
    api.SSL_write = reinterpret_cast<int (*)(SSL*, const void*, int)>(
        bind("SSL_write"));
    api.SSL_shutdown =
        reinterpret_cast<int (*)(SSL*)>(bind("SSL_shutdown"));
    api.SSL_get_verify_result =
        reinterpret_cast<long (*)(const SSL*)>(
            bind("SSL_get_verify_result"));
    return api;
  }
};

constexpr int kVerifyPeer = 0x01;  // SSL_VERIFY_PEER
constexpr long kX509VOk = 0;       // X509_V_OK

// Shared TLS plumbing: fd/ctx/ssl ownership, IO loops, teardown. The
// two subclasses differ only in handshake direction and trust setup.
// fd ownership: TlsBase ADOPTS the fd at construction (which cannot
// fail), so even when a derived constructor throws, ~TlsBase runs and
// closes the fd exactly once — the factories never close it, which is
// what prevents double-close races against concurrently accepted fds
// reusing the number.
class TlsBase : public Transport {
 public:
  ~TlsBase() override {
    if (ssl_) SslApi::Get().SSL_shutdown(ssl_);
    FreeSsl();
    if (fd_ >= 0) ::close(fd_);
  }

  void WriteAll(const char* data, size_t n) override {
    const SslApi& api = SslApi::Get();
    while (n > 0) {
      int w = api.SSL_write(ssl_, data, static_cast<int>(n));
      if (w <= 0) throw ConnectionError("raytpu: TLS write failed");
      data += w;
      n -= static_cast<size_t>(w);
    }
  }

  void ReadAll(char* data, size_t n) override {
    const SslApi& api = SslApi::Get();
    while (n > 0) {
      int r = api.SSL_read(ssl_, data, static_cast<int>(n));
      if (r <= 0) throw ConnectionError("raytpu: TLS connection closed");
      data += r;
      n -= static_cast<size_t>(r);
    }
  }

 protected:
  explicit TlsBase(int fd) : fd_(fd) {}

  void FreeSsl() {
    const SslApi& api = SslApi::Get();
    if (ssl_) api.SSL_free(ssl_);
    if (ctx_) api.SSL_CTX_free(ctx_);
    ssl_ = nullptr;
    ctx_ = nullptr;
  }

  // Allocate ssl_ on ctx_ and bind the fd; throws (leaving the fd to
  // the factory) instead of letting SSL_accept/connect crash on null.
  void NewSslOrThrow() {
    const SslApi& api = SslApi::Get();
    ssl_ = api.SSL_new(ctx_);
    if (!ssl_) {
      FreeSsl();
      throw ConnectionError("raytpu: SSL_new failed");
    }
    api.SSL_set_fd(ssl_, fd_);
  }

  int fd_;
  SslApi::SSL_CTX* ctx_ = nullptr;
  SslApi::SSL* ssl_ = nullptr;
};

class TlsTransport : public TlsBase {
 public:
  TlsTransport(int fd, const std::string& cert_path) : TlsBase(fd) {
    const SslApi& api = SslApi::Get();
    ctx_ = api.SSL_CTX_new(api.TLS_client_method());
    if (!ctx_) {
      FreeSsl();
      throw std::runtime_error("raytpu: SSL_CTX_new failed");
    }
    // Pin: the cluster cert is the only trust root.
    if (api.SSL_CTX_load_verify_locations(ctx_, cert_path.c_str(),
                                          nullptr) != 1) {
      FreeSsl();
      throw std::runtime_error("raytpu: cannot load TLS cert " +
                               cert_path);
    }
    api.SSL_CTX_set_verify(ctx_, kVerifyPeer, nullptr);
    NewSslOrThrow();
    if (api.SSL_connect(ssl_) != 1) {
      // With SSL_VERIFY_PEER, a pinning mismatch fails INSIDE the
      // handshake: read the verify result before cleanup so the
      // caller gets a non-retryable error (ReconnectingClient must
      // not spin its whole deadline against a wrong/rotated cert).
      long verify = api.SSL_get_verify_result(ssl_);
      FreeSsl();
      if (verify != kX509VOk)
        throw std::runtime_error(
            "raytpu: server certificate does not match the pinned "
            "cluster cert (verify result " + std::to_string(verify) +
            ")");
      throw ConnectionError("raytpu: TLS handshake failed");
    }
    if (api.SSL_get_verify_result(ssl_) != kX509VOk) {
      FreeSsl();
      throw std::runtime_error(
          "raytpu: server certificate does not match the pinned "
          "cluster cert");
    }
  }
};

// Server side over an ACCEPTED fd (the worker runtime's listener in a
// --tls cluster; cert/key are the cluster's own material, the same
// files the Python servers load).
class TlsServerTransport : public TlsBase {
 public:
  TlsServerTransport(int fd, const std::string& cert_path,
                     const std::string& key_path)
      : TlsBase(fd) {
    constexpr int kFiletypePem = 1;  // SSL_FILETYPE_PEM
    const SslApi& api = SslApi::Get();
    ctx_ = api.SSL_CTX_new(api.TLS_server_method());
    if (!ctx_) {
      FreeSsl();
      throw std::runtime_error("raytpu: SSL_CTX_new (server) failed");
    }
    if (api.SSL_CTX_use_certificate_chain_file(
            ctx_, cert_path.c_str()) != 1 ||
        api.SSL_CTX_use_PrivateKey_file(ctx_, key_path.c_str(),
                                        kFiletypePem) != 1) {
      FreeSsl();
      throw std::runtime_error(
          "raytpu: cannot load TLS cert/key for serving");
    }
    NewSslOrThrow();
    if (api.SSL_accept(ssl_) != 1) {
      FreeSsl();
      throw ConnectionError("raytpu: TLS accept failed");
    }
  }
};

}  // namespace

std::unique_ptr<Transport> Transport::Connect(
    const std::string& host, int port, const std::string& cert_path) {
  int fd = DialTcp(host, port);
  if (cert_path.empty())
    return std::make_unique<PlainTransport>(fd);
  // TlsBase adopted the fd the moment construction began; on a
  // handshake throw its destructor already closed it.
  return std::make_unique<TlsTransport>(fd, cert_path);
}

std::unique_ptr<Transport> Transport::Accept(
    int fd, const std::string& cert_path, const std::string& key_path) {
  if (cert_path.empty())
    return std::make_unique<PlainTransport>(fd);
  return std::make_unique<TlsServerTransport>(fd, cert_path, key_path);
}

}  // namespace raytpu
