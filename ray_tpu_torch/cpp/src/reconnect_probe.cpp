// Chaos probe: loop idempotent KV calls through ReconnectingClient
// while the test kills and restarts the head mid-stream. Prints
// "PROBE OK n=<iterations>" only if every call eventually succeeded —
// the C++ analogue of the Python ReconnectingClient chaos tests.
// Usage: raytpu_reconnect_probe <head_host:port> <iterations>
//        [token] [tls_cert]   (env fallbacks like the demo)
#include <csignal>
#include <cstdlib>
#include <iostream>

#include "raytpu/client.h"

int main(int argc, char** argv) {
  // TLS writes bypass MSG_NOSIGNAL: keep SIGPIPE from killing the
  // probe when the head dies mid-write.
  std::signal(SIGPIPE, SIG_IGN);
  if (argc < 3) {
    std::cerr << "usage: raytpu_reconnect_probe <head_host:port> "
                 "<iterations> [token] [tls_cert]\n";
    return 2;
  }
  std::string addr = argv[1];
  int iterations = std::atoi(argv[2]);
  std::string token = argc > 3 ? argv[3] : "";
  if (token.empty() && std::getenv("RAY_TPU_AUTH_TOKEN"))
    token = std::getenv("RAY_TPU_AUTH_TOKEN");
  std::string cert = argc > 4 ? argv[4] : "";
  if (cert.empty() && std::getenv("RAY_TPU_TLS_CERT"))
    cert = std::getenv("RAY_TPU_TLS_CERT");

  auto colon = addr.rfind(':');
  std::string host = addr.substr(0, colon);
  int port = std::stoi(addr.substr(colon + 1));
  raytpu::ReconnectingClient head(host, port, token, cert,
                                  /*reconnect_timeout_s=*/30.0);
  try {
    for (int i = 0; i < iterations; ++i) {
      raytpu::ValueMap put;
      put.emplace("key", raytpu::Value::S("cppprobe"));
      put.emplace("value",
                  raytpu::Value::Bin("i" + std::to_string(i)));
      put.emplace("overwrite", raytpu::Value::B(true));
      if (!head.Call("kv_put", std::move(put)).at("ok").truthy())
        throw std::runtime_error("kv_put rejected");
      raytpu::ValueMap get;
      get.emplace("key", raytpu::Value::S("cppprobe"));
      raytpu::Value reply = head.Call("kv_get", std::move(get));
      if (reply.at("value").s != "i" + std::to_string(i))
        throw std::runtime_error("kv_get mismatch at " +
                                 std::to_string(i));
      struct timespec ts {0, 100 * 1000000L};
      nanosleep(&ts, nullptr);
    }
  } catch (const std::exception& e) {
    std::cerr << "PROBE FAILED: " << e.what() << std::endl;
    return 1;
  }
  std::cout << "PROBE OK n=" << iterations << std::endl;
  return 0;
}
