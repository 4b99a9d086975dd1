// C++ driver client for a ray_tpu_torch cluster.
//
// Reference: cpp/include/ray/api.h — the reference ships a C++ worker
// API (Init/Put/Get/Task(...).Remote()); this is the TPU-native
// driver-side equivalent over the runtime's native protocol: a
// blocking TCP client speaking the versioned-msgpack control plane
// (ray_tpu_torch/_private/rpc.py framing), with cluster KV, node listing,
// and CROSS-LANGUAGE task calls — Python functions registered via
// ray_tpu_torch._private.xlang.register_function, invoked by name with
// msgpack args, results returned as msgpack (pickle never crosses the
// boundary).
//
// Usage:
//   raytpu::Client head(host, port, token);
//   head.KvPut("greeting", "hello");
//   raytpu::Driver drv(head_addr, token);
//   raytpu::Value out = drv.Call("my_fn", {raytpu::Value::I(2)});
#pragma once

#include <cstdint>
#include <functional>
#include <memory>
#include <string>
#include <vector>

#include "raytpu/msgpack_lite.h"
#include "raytpu/transport.h"

namespace raytpu {

// One rpc connection: REQ out, RESP/ERR in (PUSH frames are ignored —
// a blocking driver does not subscribe). With a non-empty cert path
// the connection runs over TLS pinned to the cluster certificate
// (start --tls; matches the Python client's pinning posture).
class Client {
 public:
  Client(const std::string& host, int port, const std::string& token,
         const std::string& cert = "");
  ~Client();
  Client(const Client&) = delete;
  Client& operator=(const Client&) = delete;

  // Call a control-plane method; kwargs is a msgpack map.
  Value Call(const std::string& method, ValueMap kwargs);

  // Block until the peer closes the connection, discarding any frames
  // (the worker runtime uses this to tie its lifetime to the node's).
  void WaitClosed();

  // -- convenience wrappers over head methods -----------------------
  void KvPut(const std::string& key, const std::string& value,
             bool overwrite = true);
  // Returns false when the key is absent.
  bool KvGet(const std::string& key, std::string* value_out);
  std::vector<std::string> KvKeys(const std::string& prefix);
  // node_id -> addr from the head's node table.
  ValueMap Nodes();

 private:
  void WriteFrame(const std::string& payload);
  std::string ReadFrame();
  std::unique_ptr<Transport> transport_;
  uint64_t next_id_ = 0;
};

// Client endpoint that survives peer restarts: re-dials with backoff
// on connection loss and retries the in-flight call until a deadline
// (semantics of the Python ReconnectingClient, _private/rpc.py:500 —
// route IDEMPOTENT methods only; a call whose response was lost is
// re-sent).
class ReconnectingClient {
 public:
  ReconnectingClient(const std::string& host, int port,
                     const std::string& token,
                     const std::string& cert = "",
                     double reconnect_timeout_s = 20.0);

  // retry=false: non-idempotent call — a transport failure after the
  // request may have been sent surfaces instead of re-sending.
  Value Call(const std::string& method, ValueMap kwargs,
             bool retry = true);

 private:
  Client& Ensure();
  std::string host_;
  int port_;
  std::string token_;
  std::string cert_;
  double reconnect_timeout_s_;
  std::unique_ptr<Client> conn_;
};

// Cross-language task driver: lease a worker, push the task, return
// the lease (the same drive cycle core_worker._drive_normal_task runs).
class Driver {
 public:
  // head_addr "host:port". Connects to the head, discovers a node.
  Driver(const std::string& head_addr, const std::string& token,
         const std::string& cert = "");

  // Invoke a Python function registered as xfn:<name> with msgpack
  // args; returns its msgpack result. Throws std::runtime_error with
  // the remote error text on failure.
  Value Call(const std::string& name, ValueVec args, double num_cpus = 1.0);

  Client& head() { return head_; }

 private:
  std::string token_;
  std::string cert_;
  Client head_;
  std::string node_host_;
  int node_port_ = 0;
};

}  // namespace raytpu
