// Demo/e2e driver: connect to a ray_tpu_torch cluster from C++, exercise the
// cluster KV, node listing, and cross-language task calls.
// Usage: raytpu_demo <head_host:port> [token] [tls_cert]
// (token/cert also read from RAY_TPU_AUTH_TOKEN / RAY_TPU_TLS_CERT.)
#include <csignal>
#include <cstdlib>
#include <iostream>

#include "raytpu/client.h"

using raytpu::Client;
using raytpu::Driver;
using raytpu::Value;
using raytpu::ValueVec;

int main(int argc, char** argv) {
  std::signal(SIGPIPE, SIG_IGN);
  if (argc < 2) {
    std::cerr << "usage: raytpu_demo <head_host:port> [token] [tls_cert]\n";
    return 2;
  }
  std::string head_addr = argv[1];
  std::string token = argc > 2 ? argv[2] : "";
  if (token.empty() && std::getenv("RAY_TPU_AUTH_TOKEN"))
    token = std::getenv("RAY_TPU_AUTH_TOKEN");
  std::string cert = argc > 3 ? argv[3] : "";
  if (cert.empty() && std::getenv("RAY_TPU_TLS_CERT"))
    cert = std::getenv("RAY_TPU_TLS_CERT");

  try {
    Driver drv(head_addr, token, cert);

    // 1. Cluster KV round trip.
    drv.head().KvPut("cpp:hello", "from-cpp");
    std::string got;
    if (!drv.head().KvGet("cpp:hello", &got)) throw std::runtime_error("kv miss");
    std::cout << "KV " << got << "\n";

    // 2. Node discovery.
    std::cout << "NODES " << drv.head().Nodes().size() << "\n";

    // 3. Cross-language call: Python fn registered as xfn:cpp_add.
    Value sum = drv.Call("cpp_add", {Value::I(19), Value::I(23)});
    std::cout << "ADD " << sum.i << "\n";

    // 4. Structured args/result: list in, map out.
    ValueVec nums;
    for (int i = 1; i <= 4; ++i) nums.push_back(Value::I(i * i));
    Value stats = drv.Call("cpp_stats", {Value::A(std::move(nums))});
    std::cout << "STATS sum=" << stats.at("sum").i
              << " mean=" << stats.at("mean").f << "\n";

    // 5. Remote errors surface as text, not pickle.
    try {
      drv.Call("cpp_boom", {});
      std::cout << "ERROR missing\n";
      return 1;
    } catch (const std::exception& e) {
      std::cout << "RAISED " << e.what() << "\n";
    }
  } catch (const std::exception& e) {
    std::cerr << "FATAL " << e.what() << "\n";
    return 1;
  }
  std::cout << "CPP DRIVER OK\n";
  return 0;
}
