// C++-defined remote functions: registration + typed adapters.
//
// Reference: cpp/include/ray/api/ray_remote.h — the reference's
// RAY_REMOTE macro registers C++ functions at static-init time so a
// C++ worker can execute tasks submitted from any language. This is
// the TPU-native equivalent: functions register under a stable NAME,
// a Python (or C++) driver submits a task with fn_id "cfn:<name>" and
// msgpack args, and the raytpu worker runtime (worker.cpp) executes
// the registered function — arguments and results cross the language
// boundary as msgpack only, never pickle.
//
// Usage:
//   int64_t Add(int64_t a, int64_t b) { return a + b; }
//   RAYTPU_REMOTE(Add);
//   // Python: ray_tpu_torch.cross_language.cpp_function("Add").remote(1, 2)
//
// Raw-Value functions (variadic / heterogeneous args) register too:
//   raytpu::Value Stats(const raytpu::ValueVec& args);
//   RAYTPU_REMOTE(Stats);
#pragma once

#include <functional>
#include <map>
#include <stdexcept>
#include <string>
#include <utility>

#include "raytpu/msgpack_lite.h"

namespace raytpu {

using TaskFn = std::function<Value(const ValueVec&)>;

// name -> function. A plain function-local static: initialization-order
// safe for the static registrars the macro expands to.
inline std::map<std::string, TaskFn>& FunctionRegistry() {
  static std::map<std::string, TaskFn> registry;
  return registry;
}

inline bool RegisterFunction(const std::string& name, TaskFn fn) {
  auto [it, inserted] = FunctionRegistry().emplace(name, std::move(fn));
  (void)it;
  if (!inserted)
    throw std::runtime_error("raytpu: duplicate RAYTPU_REMOTE name " + name);
  return true;
}

// ---- typed argument adapters (msgpack scalar types) -----------------
template <typename T>
T ValueTo(const Value& v);

template <>
inline int64_t ValueTo<int64_t>(const Value& v) {
  if (v.kind == Value::Kind::Int) return v.i;
  if (v.kind == Value::Kind::Float) return static_cast<int64_t>(v.f);
  throw std::runtime_error("raytpu: argument is not an integer");
}

template <>
inline double ValueTo<double>(const Value& v) {
  if (v.kind == Value::Kind::Float) return v.f;
  if (v.kind == Value::Kind::Int) return static_cast<double>(v.i);
  throw std::runtime_error("raytpu: argument is not a number");
}

template <>
inline std::string ValueTo<std::string>(const Value& v) {
  if (v.kind == Value::Kind::Str || v.kind == Value::Kind::Bin) return v.s;
  throw std::runtime_error("raytpu: argument is not a string");
}

template <>
inline bool ValueTo<bool>(const Value& v) {
  if (v.kind == Value::Kind::Bool) return v.b;
  throw std::runtime_error("raytpu: argument is not a bool");
}

inline Value ToValue(int64_t v) { return Value::I(v); }
inline Value ToValue(int v) { return Value::I(v); }
inline Value ToValue(double v) { return Value::F(v); }
inline Value ToValue(const std::string& v) { return Value::S(v); }
inline Value ToValue(bool v) { return Value::B(v); }
inline Value ToValue(Value v) { return v; }

namespace detail {

template <typename R, typename... Args, std::size_t... I>
TaskFn WrapTyped(R (*fn)(Args...), std::index_sequence<I...>) {
  return [fn](const ValueVec& args) -> Value {
    if (args.size() != sizeof...(Args))
      throw std::runtime_error(
          "raytpu: expected " + std::to_string(sizeof...(Args)) +
          " arguments, got " + std::to_string(args.size()));
    return ToValue(fn(ValueTo<std::decay_t<Args>>(args[I])...));
  };
}

// Raw form: Value fn(const ValueVec&) registers unwrapped.
inline TaskFn Wrap(Value (*fn)(const ValueVec&)) { return fn; }

template <typename R, typename... Args>
TaskFn Wrap(R (*fn)(Args...)) {
  return WrapTyped(fn, std::index_sequence_for<Args...>{});
}

}  // namespace detail
}  // namespace raytpu

// Static-init registration, like the reference's RAY_REMOTE.
#define RAYTPU_REMOTE(fn)                                        \
  static const bool _raytpu_registered_##fn =                    \
      ::raytpu::RegisterFunction(#fn, ::raytpu::detail::Wrap(fn))
