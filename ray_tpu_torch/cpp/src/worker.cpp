// raytpu C++ worker runtime: execute RAYTPU_REMOTE-registered
// functions as cluster tasks.
//
// Reference: cpp/src/ray/runtime/task/task_executor.cc — the
// reference's C++ worker receives leased tasks from the raylet and
// executes functions registered by RAY_REMOTE. TPU-native shape: the
// worker is an RPC SERVER speaking the runtime's versioned-msgpack
// wire (ray_tpu_torch/_private/rpc.py framing). The node manager spawns this
// binary for leases whose runtime_env is {"language": "cpp"}
// (node.py _spawn_worker_cpp, config RAY_TPU_CPP_WORKER_CMD); it
// registers back like a Python worker and then serves push_task —
// drivers in ANY language connect to its advertised address and push
// specs whose fn_id is "cfn:<name>".
//
// Protocol surface served: push_task, ping, exit_worker. Execution is
// serialized (a worker is leased to one driver at a time; the mutex
// guards against overlapped pushes). Errors travel as
// {"status": "error", "error_text": ...} — the Python owner raises a
// RayTaskError from the text (pickle never crosses the boundary).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <csignal>
#include <cstdlib>
#include <cstring>
#include <iostream>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include "raytpu/client.h"
#include "raytpu/msgpack_lite.h"
#include "raytpu/ray_remote.h"
#include "raytpu/transport.h"
#include "raytpu/wire.h"

namespace raytpu {
namespace {

using wire::kReq;
using wire::kResp;
using wire::kWireVersion;

bool WriteFrame(Transport& t, const std::string& payload) {
  char hdr[5];
  wire::PutLe32(hdr, static_cast<uint32_t>(payload.size() + 1));
  hdr[4] = static_cast<char>(kWireVersion);
  try {
    t.WriteAll(hdr, 5);
    t.WriteAll(payload.data(), payload.size());
    return true;
  } catch (const ConnectionError&) {
    return false;
  }
}

// Reads one framed blob WITHOUT interpreting the version byte — the
// auth preamble has none, frames do.
bool ReadBlob(Transport& t, std::string* out, uint32_t max_len = 1u << 30) {
  char hdr[4];
  try {
    t.ReadAll(hdr, 4);
    uint32_t len = wire::GetLe32(hdr);
    if (len == 0 || len > max_len) return false;
    out->resize(len);
    t.ReadAll(out->data(), len);
    return true;
  } catch (const ConnectionError&) {
    return false;
  }
}

std::mutex g_exec_mutex;

Value ExecutePushTask(const Value& spec) {
  const Value& fn_id = spec.at("fn_id");
  std::string name = fn_id.s;
  if (name.rfind("cfn:", 0) == 0) name = name.substr(4);
  auto it = FunctionRegistry().find(name);
  if (it == FunctionRegistry().end())
    throw std::runtime_error("cpp function '" + name +
                             "' is not registered in this worker");
  ValueVec args;
  const Value& arg_entries = spec.at("args");
  if (arg_entries.kind == Value::Kind::Array) {
    for (const auto& entry : *arg_entries.arr) {
      // (slot, "mp", msgpack-bytes): cross-language args only.
      if (!entry.arr || entry.arr->size() < 3 || (*entry.arr)[1].s != "mp")
        throw std::runtime_error(
            "cpp worker accepts msgpack ('mp') arguments only");
      args.push_back(decode((*entry.arr)[2].s));
    }
  }
  Value result;
  {
    std::lock_guard<std::mutex> lock(g_exec_mutex);
    result = it->second(args);
  }
  // Result oid mirrors ids.py ObjectID.for_return(task_id, 0):
  // task binary + 4-byte big-endian index (hex: 8 zero chars).
  std::string oid_hex = spec.at("task_id").s + "00000000";
  ValueVec triple;
  triple.push_back(Value::S(oid_hex));
  triple.push_back(Value::S("xmp"));
  triple.push_back(Value::Bin(encode(result)));
  ValueVec results;
  results.push_back(Value::A(std::move(triple)));
  ValueMap reply;
  reply.emplace("status", Value::S("ok"));
  reply.emplace("results", Value::A(std::move(results)));
  return Value::M(std::move(reply));
}

void ServeConn(int fd, const std::string& token,
               const std::string& cert, const std::string& key) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  std::unique_ptr<Transport> transport;
  try {
    // Accept owns the fd: it closes exactly once on failure.
    transport = Transport::Accept(fd, cert, key);
  } catch (const std::exception& e) {
    // A TLS misconfiguration (bad key, missing cert) silently eating
    // every connection is undebuggable: say why each accept died.
    std::cerr << "raytpu_worker: connection rejected: " << e.what()
              << std::endl;
    return;
  }
  Transport& t = *transport;
  std::string blob;
  if (!token.empty()) {
    // First blob must be the auth preamble; constant-time-ish compare
    // is unnecessary here (the token has full entropy and this worker
    // binds like the Python workers do).
    if (!ReadBlob(t, &blob, 4096) || blob != "RTPUAUTH" + token)
      return;  // transport dtor closes the fd
  }
  for (;;) {
    if (!ReadBlob(t, &blob)) break;
    if (static_cast<uint8_t>(blob[0]) != kWireVersion) break;
    Value frame;
    int64_t req_id = 0;
    try {
      frame = decode(blob.substr(1));
      if (frame.kind != Value::Kind::Array || frame.arr->size() != 3 ||
          (*frame.arr)[0].i != kReq)
        break;
      req_id = (*frame.arr)[1].i;
      const Value& payload = (*frame.arr)[2];
      // The worker binds a real port: validate the payload shape
      // before dereferencing (a malformed frame must fail the request,
      // not segfault the process and every in-flight task with it).
      if (payload.kind != Value::Kind::Array || !payload.arr ||
          payload.arr->size() < 2)
        throw std::runtime_error("cpp worker: malformed request payload");
      const std::string& method = (*payload.arr)[0].s;
      const Value& kwargs = (*payload.arr)[1];
      Value result;
      if (method == "push_task") {
        result = ExecutePushTask(kwargs.at("spec"));
      } else if (method == "ping") {
        ValueMap ok;
        ok.emplace("ok", Value::B(true));
        result = Value::M(std::move(ok));
      } else if (method == "exit_worker") {
        ValueMap ok;
        ok.emplace("ok", Value::B(true));
        ValueVec resp;
        resp.push_back(Value::I(kResp));
        resp.push_back(Value::I(req_id));
        resp.push_back(Value::M(std::move(ok)));
        WriteFrame(t, encode(Value::A(std::move(resp))));
        std::exit(0);
      } else {
        throw std::runtime_error("cpp worker: unknown method " + method);
      }
      ValueVec resp;
      resp.push_back(Value::I(kResp));
      resp.push_back(Value::I(req_id));
      resp.push_back(std::move(result));
      if (!WriteFrame(t, encode(Value::A(std::move(resp))))) break;
    } catch (const std::exception& e) {
      // Task-level failures travel as status=error replies (the owner
      // raises RayTaskError); only protocol-level breakage uses kErr.
      ValueMap reply;
      reply.emplace("status", Value::S("error"));
      reply.emplace("error_text", Value::S(e.what()));
      ValueVec resp;
      resp.push_back(Value::I(kResp));
      resp.push_back(Value::I(req_id));
      resp.push_back(Value::M(std::move(reply)));
      if (!WriteFrame(t, encode(Value::A(std::move(resp))))) break;
    }
  }
}

std::string EnvOr(const char* key, const std::string& fallback) {
  const char* v = std::getenv(key);
  return v ? std::string(v) : fallback;
}

}  // namespace

int WorkerMain() {
  ::signal(SIGPIPE, SIG_IGN);
  std::string node_addr = EnvOr("RAY_TPU_NODE_ADDR", "");
  std::string worker_id = EnvOr("RAY_TPU_WORKER_ID", "");
  std::string token = EnvOr("RAY_TPU_AUTH_TOKEN", "");
  // In a --tls cluster the node exports the cluster cert/key; the
  // worker then dials out TLS-pinned AND serves TLS itself.
  std::string cert = EnvOr("RAY_TPU_TLS_CERT", "");
  std::string key = EnvOr("RAY_TPU_TLS_KEY", "");
  if (node_addr.empty() || worker_id.empty()) {
    std::cerr << "raytpu_worker: RAY_TPU_NODE_ADDR and RAY_TPU_WORKER_ID "
                 "must be set (this binary is spawned by the node manager)"
              << std::endl;
    return 2;
  }
  auto colon = node_addr.rfind(':');
  std::string node_host = node_addr.substr(0, colon);
  int node_port = std::stoi(node_addr.substr(colon + 1));

  // Listening endpoint: same interface family/host the node uses.
  int listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (listen_fd < 0) return 2;
  int one = 1;
  ::setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = 0;
  if (::bind(listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) !=
          0 ||
      ::listen(listen_fd, 16) != 0) {
    std::cerr << "raytpu_worker: cannot bind" << std::endl;
    return 2;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  int port = ntohs(addr.sin_port);
  std::string my_addr = node_host + ":" + std::to_string(port);

  // Register with the node over a persistent connection; its closure
  // means the node died -> exit (same contract as worker_main.py).
  auto* node = new Client(node_host, node_port, token, cert);
  ValueMap kw;
  kw.emplace("worker_id", Value::S(worker_id));
  kw.emplace("addr", Value::S(my_addr));
  kw.emplace("pid", Value::I(static_cast<int64_t>(::getpid())));
  Value reply = node->Call("register_worker", std::move(kw));
  if (!reply.at("ok").truthy()) {
    std::cerr << "raytpu_worker: registration rejected" << std::endl;
    return 2;
  }
  std::cerr << "raytpu_worker " << worker_id.substr(0, 8) << " serving "
            << my_addr << " (" << FunctionRegistry().size()
            << " registered fns)" << std::endl;
  std::thread([node] {
    // Blocking read on the node connection: EOF = node gone.
    node->WaitClosed();
    std::exit(0);
  }).detach();

  for (;;) {
    int fd = ::accept(listen_fd, nullptr, nullptr);
    if (fd < 0) continue;
    std::thread(ServeConn, fd, token, cert, key).detach();
  }
}

}  // namespace raytpu
