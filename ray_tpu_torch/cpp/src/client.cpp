// See client.h. Wire framing per ray_tpu_torch/_private/rpc.py:
//   [u32 le length][u8 wire-version=1][msgpack (kind, req_id, payload)]
// auth preamble: [u32 le length]["RTPUAUTH" + token]

#include "raytpu/client.h"

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstring>
#include <random>
#include <sstream>
#include <stdexcept>

#include "raytpu/wire.h"

namespace raytpu {

namespace {
using wire::kErr;
using wire::kPush;
using wire::kReq;
using wire::kResp;
using wire::kWireVersion;

std::string RandomHex(int bytes) {
  static thread_local std::mt19937_64 rng{std::random_device{}()};
  static const char* hex = "0123456789abcdef";
  std::string out;
  out.reserve(bytes * 2);
  for (int i = 0; i < bytes; ++i) {
    uint8_t b = static_cast<uint8_t>(rng());
    out.push_back(hex[b >> 4]);
    out.push_back(hex[b & 0xf]);
  }
  return out;
}

void SplitAddr(const std::string& addr, std::string* host, int* port) {
  if (!addr.empty() && addr[0] == '[') {
    // Bracketed IPv6 literal: "[::1]:8000".
    auto close = addr.find(']');
    if (close == std::string::npos || close + 1 >= addr.size() ||
        addr[close + 1] != ':')
      throw std::runtime_error("raytpu: address must be [v6host]:port");
    *host = addr.substr(1, close - 1);
    *port = std::stoi(addr.substr(close + 2));
    return;
  }
  // Unbracketed: split at the LAST colon. The port is always the final
  // component, so this is also correct for the unbracketed IPv6
  // literals the Python side announces (node/head format addresses as
  // f"{host}:{port}" with no brackets).
  auto pos = addr.rfind(':');
  if (pos == std::string::npos)
    throw std::runtime_error("raytpu: address must be host:port");
  *host = addr.substr(0, pos);
  *port = std::stoi(addr.substr(pos + 1));
}

using wire::GetLe32;
using wire::PutLe32;

void SleepMs(int ms) {
  struct timespec ts {
    ms / 1000, (ms % 1000) * 1000000L
  };
  nanosleep(&ts, nullptr);
}

double NowS() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}
}  // namespace

Client::Client(const std::string& host, int port, const std::string& token,
               const std::string& cert)
    : transport_(Transport::Connect(host, port, cert)) {
  if (!token.empty()) {
    std::string blob = "RTPUAUTH" + token;
    uint32_t len = static_cast<uint32_t>(blob.size());
    char hdr[4];
    PutLe32(hdr, len);
    transport_->WriteAll(hdr, 4);
    transport_->WriteAll(blob.data(), blob.size());
  }
}

Client::~Client() = default;

void Client::WriteFrame(const std::string& payload) {
  uint32_t len = static_cast<uint32_t>(payload.size() + 1);
  char hdr[5];
  PutLe32(hdr, len);
  hdr[4] = static_cast<char>(kWireVersion);
  transport_->WriteAll(hdr, 5);
  transport_->WriteAll(payload.data(), payload.size());
}

std::string Client::ReadFrame() {
  char hdr[4];
  transport_->ReadAll(hdr, 4);
  uint32_t len = GetLe32(hdr);
  if (len == 0) throw std::runtime_error("raytpu: empty frame");
  std::string body(len, '\0');
  transport_->ReadAll(body.data(), len);
  if (static_cast<uint8_t>(body[0]) != kWireVersion)
    throw std::runtime_error("raytpu: wire version mismatch");
  return body.substr(1);
}

Value Client::Call(const std::string& method, ValueMap kwargs) {
  uint64_t req_id = ++next_id_;
  Value frame = Value::A({
      Value::I(kReq),
      Value::I(static_cast<int64_t>(req_id)),
      Value::A({Value::S(method), Value::M(std::move(kwargs))}),
  });
  WriteFrame(encode(frame));
  for (;;) {
    Value reply = decode(ReadFrame());
    if (reply.kind != Value::Kind::Array || reply.arr->size() != 3)
      throw std::runtime_error("raytpu: malformed reply frame");
    int64_t kind = (*reply.arr)[0].i;
    int64_t rid = (*reply.arr)[1].i;
    if (kind == kPush) continue;  // driver has no subscriptions
    if (rid != static_cast<int64_t>(req_id)) continue;  // stale
    if (kind == kErr)
      throw std::runtime_error("raytpu rpc error: " + (*reply.arr)[2].s);
    return (*reply.arr)[2];
  }
}

void Client::WaitClosed() {
  try {
    for (;;) (void)ReadFrame();
  } catch (const std::exception&) {
    // connection closed (or broke) — either way, the peer is gone.
  }
}

void Client::KvPut(const std::string& key, const std::string& value,
                   bool overwrite) {
  ValueMap kw;
  kw.emplace("key", Value::S(key));
  kw.emplace("value", Value::Bin(value));
  kw.emplace("overwrite", Value::B(overwrite));
  Value reply = Call("kv_put", std::move(kw));
  if (!reply.at("ok").truthy())
    throw std::runtime_error("raytpu: kv_put rejected for " + key);
}

bool Client::KvGet(const std::string& key, std::string* value_out) {
  ValueMap kw;
  kw.emplace("key", Value::S(key));
  Value reply = Call("kv_get", std::move(kw));
  if (!reply.at("ok").truthy()) return false;
  if (value_out) *value_out = reply.at("value").s;
  return true;
}

std::vector<std::string> Client::KvKeys(const std::string& prefix) {
  ValueMap kw;
  kw.emplace("prefix", Value::S(prefix));
  Value reply = Call("kv_keys", std::move(kw));
  std::vector<std::string> out;
  const Value& keys = reply.at("keys");
  if (keys.kind == Value::Kind::Array)
    for (const auto& k : *keys.arr) out.push_back(k.s);
  return out;
}

ValueMap Client::Nodes() {
  Value reply = Call("node_table", {});
  ValueMap out;
  if (reply.kind == Value::Kind::Map)
    for (const auto& [nid, info] : *reply.map)
      out.emplace(nid, info.at("addr"));
  return out;
}

Client& ReconnectingClient::Ensure() {
  if (!conn_)
    conn_ = std::make_unique<Client>(host_, port_, token_, cert_);
  return *conn_;
}

ReconnectingClient::ReconnectingClient(const std::string& host, int port,
                                       const std::string& token,
                                       const std::string& cert,
                                       double reconnect_timeout_s)
    : host_(host),
      port_(port),
      token_(token),
      cert_(cert),
      reconnect_timeout_s_(reconnect_timeout_s) {}

Value ReconnectingClient::Call(const std::string& method, ValueMap kwargs,
                               bool retry) {
  double deadline = NowS() + reconnect_timeout_s_;
  int backoff_ms = 200;
  for (;;) {
    // Dial and request are SEPARATE failure classes (the Python
    // client's err.sent distinction): a dial failure provably never
    // sent the request, so even retry=false calls re-dial; once the
    // request may have hit the wire, only idempotent (retry=true)
    // calls re-send — a lost RESPONSE must not double-execute a
    // non-idempotent method.
    bool dialed = false;
    try {
      Client& conn = Ensure();
      dialed = true;
      // kwargs are consumed by the encode; keep a copy for retries.
      ValueMap kw = kwargs;
      return conn.Call(method, std::move(kw));
    } catch (const ConnectionError& e) {
      conn_.reset();
      if (dialed && !retry) throw;
      if (NowS() >= deadline)
        throw ConnectionError(std::string("raytpu: peer did not come "
                                          "back within deadline: ") +
                              e.what());
      SleepMs(backoff_ms);
      backoff_ms = backoff_ms < 2000 ? backoff_ms * 2 : 2000;
    }
  }
}

Driver::Driver(const std::string& head_addr, const std::string& token,
               const std::string& cert)
    : token_(token),
      cert_(cert),
      head_([&] {
        std::string host;
        int port;
        SplitAddr(head_addr, &host, &port);
        return std::pair<std::string, int>(host, port);
      }()
                .first,
            [&] {
              std::string host;
              int port;
              SplitAddr(head_addr, &host, &port);
              return port;
            }(),
            token, cert) {
  // Probe the table: entries for recently-departed drivers linger
  // until the head's health sweep, so take the first node that
  // actually accepts a connection.
  ValueMap nodes = head_.Nodes();
  for (const auto& [nid, addr] : nodes) {
    (void)nid;
    std::string host;
    int port = 0;
    try {
      SplitAddr(addr.s, &host, &port);
      Client probe(host, port, token_, cert_);
      node_host_ = host;
      node_port_ = port;
      return;
    } catch (const std::exception&) {
      continue;
    }
  }
  throw std::runtime_error("raytpu: no reachable node in the cluster");
}

Value Driver::Call(const std::string& name, ValueVec args, double num_cpus) {
  Client node(node_host_, node_port_, token_, cert_);
  ValueMap resources;
  resources.emplace("CPU", Value::F(num_cpus));
  ValueMap lease_kw;
  lease_kw.emplace("resources", Value::M(std::move(resources)));
  lease_kw.emplace("actor", Value::B(false));
  Value lease = node.Call("lease_worker", std::move(lease_kw));
  if (!lease.at("ok").truthy())
    throw std::runtime_error("raytpu: lease failed: " + lease.at("error").s);
  std::string lease_id = lease.at("lease_id").s;
  std::string worker_addr = lease.at("addr").s;

  // Build the task spec: msgpack args, msgpack result (xlang=true).
  ValueVec encoded_args;
  for (auto& a : args) {
    ValueVec entry;
    entry.push_back(Value::Nil());  // positional slot
    entry.push_back(Value::S("mp"));
    entry.push_back(Value::Bin(encode(a)));
    encoded_args.push_back(Value::A(std::move(entry)));
  }
  ValueMap spec;
  spec.emplace("task_id", Value::S(RandomHex(16)));  // TaskID: 16 bytes
  spec.emplace("fn_id", Value::S("xfn:" + name));
  spec.emplace("args", Value::A(std::move(encoded_args)));
  spec.emplace("num_returns", Value::I(1));
  spec.emplace("name", Value::S(name));
  spec.emplace("xlang", Value::B(true));
  ValueMap push_kw;
  push_kw.emplace("spec", Value::M(std::move(spec)));

  std::string whost;
  int wport;
  SplitAddr(worker_addr, &whost, &wport);
  Value reply;
  try {
    Client worker(whost, wport, token_, cert_);
    reply = worker.Call("push_task", std::move(push_kw));
  } catch (...) {
    ValueMap ret;
    ret.emplace("lease_id", Value::S(lease_id));
    try { node.Call("return_lease", std::move(ret)); } catch (...) {}
    throw;
  }
  ValueMap ret;
  ret.emplace("lease_id", Value::S(lease_id));
  node.Call("return_lease", std::move(ret));

  if (reply.at("status").s != "ok") {
    std::string text = reply.at("error_text").s;
    throw std::runtime_error("raytpu task failed: " +
                             (text.empty() ? "(see worker log)" : text));
  }
  const Value& results = reply.at("results");
  if (results.kind != Value::Kind::Array || results.arr->empty())
    return Value::Nil();
  const Value& first = (*results.arr)[0];
  // (oid_hex, "xmp", msgpack-bytes)
  if (first.arr && first.arr->size() >= 3 && (*first.arr)[1].s == "xmp")
    return decode((*first.arr)[2].s);
  throw std::runtime_error("raytpu: unexpected result kind (not xlang?)");
}

}  // namespace raytpu
