// Minimal msgpack codec for the ray_tpu_torch control plane.
//
// Reference frame: the wire format is versioned msgpack
// (ray_tpu_torch/_private/rpc.py pack_frame/unpack_frame; the reference's
// cross-language serialization is msgpack as well,
// python/ray/cross_language.py). This implements exactly the subset
// the control plane speaks: nil, bool, int, float64, str, bin,
// array, map<str|int, value>.
#pragma once

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace raytpu {

struct Value;
using ValueVec = std::vector<Value>;
using ValueMap = std::map<std::string, Value>;

struct Value {
  enum class Kind { Nil, Bool, Int, Float, Str, Bin, Array, Map };
  Kind kind = Kind::Nil;
  bool b = false;
  int64_t i = 0;
  double f = 0.0;
  std::string s;           // Str and Bin both live here
  std::shared_ptr<ValueVec> arr;
  std::shared_ptr<ValueMap> map;

  Value() = default;
  static Value Nil() { return Value(); }
  static Value B(bool v) { Value x; x.kind = Kind::Bool; x.b = v; return x; }
  static Value I(int64_t v) { Value x; x.kind = Kind::Int; x.i = v; return x; }
  static Value F(double v) { Value x; x.kind = Kind::Float; x.f = v; return x; }
  static Value S(std::string v) {
    Value x; x.kind = Kind::Str; x.s = std::move(v); return x;
  }
  static Value Bin(std::string v) {
    Value x; x.kind = Kind::Bin; x.s = std::move(v); return x;
  }
  static Value A(ValueVec v) {
    Value x; x.kind = Kind::Array;
    x.arr = std::make_shared<ValueVec>(std::move(v)); return x;
  }
  static Value M(ValueMap v) {
    Value x; x.kind = Kind::Map;
    x.map = std::make_shared<ValueMap>(std::move(v)); return x;
  }

  bool is_nil() const { return kind == Kind::Nil; }
  bool truthy() const {
    switch (kind) {
      case Kind::Nil: return false;
      case Kind::Bool: return b;
      case Kind::Int: return i != 0;
      case Kind::Float: return f != 0.0;
      case Kind::Str: case Kind::Bin: return !s.empty();
      case Kind::Array: return arr && !arr->empty();
      case Kind::Map: return map && !map->empty();
    }
    return false;
  }
  const Value& at(const std::string& key) const {
    static const Value kNil;
    if (kind != Kind::Map || !map) return kNil;
    auto it = map->find(key);
    return it == map->end() ? kNil : it->second;
  }
};

// ----------------------------------------------------------- encoding

inline void put_be(std::string& out, uint64_t v, int bytes) {
  for (int shift = (bytes - 1) * 8; shift >= 0; shift -= 8)
    out.push_back(static_cast<char>((v >> shift) & 0xff));
}

inline void encode(const Value& v, std::string& out) {
  using K = Value::Kind;
  switch (v.kind) {
    case K::Nil: out.push_back('\xc0'); break;
    case K::Bool: out.push_back(v.b ? '\xc3' : '\xc2'); break;
    case K::Int: {
      int64_t x = v.i;
      if (x >= 0 && x < 128) out.push_back(static_cast<char>(x));
      else if (x < 0 && x >= -32) out.push_back(static_cast<char>(x));
      else { out.push_back('\xd3'); put_be(out, static_cast<uint64_t>(x), 8); }
      break;
    }
    case K::Float: {
      out.push_back('\xcb');
      uint64_t bits; std::memcpy(&bits, &v.f, 8);
      put_be(out, bits, 8);
      break;
    }
    case K::Str: {
      size_t n = v.s.size();
      if (n < 32) out.push_back(static_cast<char>(0xa0 | n));
      else if (n < 256) { out.push_back('\xd9'); put_be(out, n, 1); }
      else { out.push_back('\xdb'); put_be(out, n, 4); }
      out.append(v.s);
      break;
    }
    case K::Bin: {
      size_t n = v.s.size();
      if (n < 256) { out.push_back('\xc4'); put_be(out, n, 1); }
      else { out.push_back('\xc6'); put_be(out, n, 4); }
      out.append(v.s);
      break;
    }
    case K::Array: {
      size_t n = v.arr ? v.arr->size() : 0;
      if (n < 16) out.push_back(static_cast<char>(0x90 | n));
      else { out.push_back('\xdd'); put_be(out, n, 4); }
      if (v.arr) for (const auto& e : *v.arr) encode(e, out);
      break;
    }
    case K::Map: {
      size_t n = v.map ? v.map->size() : 0;
      if (n < 16) out.push_back(static_cast<char>(0x80 | n));
      else { out.push_back('\xdf'); put_be(out, n, 4); }
      if (v.map)
        for (const auto& [k, e] : *v.map) { encode(Value::S(k), out); encode(e, out); }
      break;
    }
  }
}

inline std::string encode(const Value& v) {
  std::string out;
  encode(v, out);
  return out;
}

// ----------------------------------------------------------- decoding

struct Cursor {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  uint8_t u8() {
    if (off >= n) throw std::runtime_error("msgpack: truncated");
    return p[off++];
  }
  uint64_t be(int bytes) {
    uint64_t v = 0;
    for (int k = 0; k < bytes; ++k) v = (v << 8) | u8();
    return v;
  }
  std::string take(size_t len) {
    if (off + len > n) throw std::runtime_error("msgpack: truncated body");
    std::string out(reinterpret_cast<const char*>(p + off), len);
    off += len;
    return out;
  }
};

inline Value decode(Cursor& c);

inline Value decode_map(Cursor& c, size_t n) {
  ValueMap m;
  for (size_t k = 0; k < n; ++k) {
    Value key = decode(c);
    std::string ks;
    if (key.kind == Value::Kind::Str || key.kind == Value::Kind::Bin) ks = key.s;
    else if (key.kind == Value::Kind::Int) ks = std::to_string(key.i);
    else throw std::runtime_error("msgpack: unsupported map key kind");
    m.emplace(std::move(ks), decode(c));
  }
  return Value::M(std::move(m));
}

inline Value decode_arr(Cursor& c, size_t n) {
  ValueVec a;
  a.reserve(n);
  for (size_t k = 0; k < n; ++k) a.push_back(decode(c));
  return Value::A(std::move(a));
}

inline Value decode(Cursor& c) {
  uint8_t t = c.u8();
  if (t < 0x80) return Value::I(t);                       // pos fixint
  if (t >= 0xe0) return Value::I(static_cast<int8_t>(t)); // neg fixint
  if ((t & 0xf0) == 0x80) return decode_map(c, t & 0x0f); // fixmap
  if ((t & 0xf0) == 0x90) return decode_arr(c, t & 0x0f); // fixarray
  if ((t & 0xe0) == 0xa0) return Value::S(c.take(t & 0x1f)); // fixstr
  switch (t) {
    case 0xc0: return Value::Nil();
    case 0xc2: return Value::B(false);
    case 0xc3: return Value::B(true);
    case 0xc4: return Value::Bin(c.take(c.be(1)));
    case 0xc5: return Value::Bin(c.take(c.be(2)));
    case 0xc6: return Value::Bin(c.take(c.be(4)));
    case 0xca: {  // float32
      uint32_t bits = static_cast<uint32_t>(c.be(4));
      float fv; std::memcpy(&fv, &bits, 4);
      return Value::F(fv);
    }
    case 0xcb: {  // float64
      uint64_t bits = c.be(8);
      double fv; std::memcpy(&fv, &bits, 8);
      return Value::F(fv);
    }
    case 0xcc: return Value::I(static_cast<int64_t>(c.be(1)));
    case 0xcd: return Value::I(static_cast<int64_t>(c.be(2)));
    case 0xce: return Value::I(static_cast<int64_t>(c.be(4)));
    case 0xcf: return Value::I(static_cast<int64_t>(c.be(8)));
    case 0xd0: return Value::I(static_cast<int8_t>(c.be(1)));
    case 0xd1: return Value::I(static_cast<int16_t>(c.be(2)));
    case 0xd2: return Value::I(static_cast<int32_t>(c.be(4)));
    case 0xd3: return Value::I(static_cast<int64_t>(c.be(8)));
    case 0xd9: return Value::S(c.take(c.be(1)));
    case 0xda: return Value::S(c.take(c.be(2)));
    case 0xdb: return Value::S(c.take(c.be(4)));
    case 0xdc: return decode_arr(c, c.be(2));
    case 0xdd: return decode_arr(c, c.be(4));
    case 0xde: return decode_map(c, c.be(2));
    case 0xdf: return decode_map(c, c.be(4));
  }
  throw std::runtime_error("msgpack: unsupported type byte");
}

inline Value decode(const std::string& buf) {
  Cursor c{reinterpret_cast<const uint8_t*>(buf.data()), buf.size()};
  return decode(c);
}

}  // namespace raytpu
