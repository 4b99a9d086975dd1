// Demo/test raytpu C++ worker: a handful of RAYTPU_REMOTE functions
// plus the worker runtime entry point. Build: make -C cpp (produces
// build/raytpu_worker); the node manager spawns it when
// RAY_TPU_CPP_WORKER_CMD points here and a task's runtime_env is
// {"language": "cpp"}.
//
// Reference shape: cpp/src/ray/runtime/task/task_executor.cc executes
// RAY_REMOTE-registered functions; these examples mirror the
// reference's cpp/example functions in spirit.

#include <algorithm>
#include <stdexcept>
#include <string>

#include "raytpu/ray_remote.h"

namespace {

int64_t Add(int64_t a, int64_t b) { return a + b; }
RAYTPU_REMOTE(Add);

double Mul(double a, double b) { return a * b; }
RAYTPU_REMOTE(Mul);

std::string Greet(std::string name) { return "hello " + name; }
RAYTPU_REMOTE(Greet);

// Raw-Value form: heterogeneous args, structured return.
raytpu::Value SortInts(const raytpu::ValueVec& args) {
  if (args.empty() || args[0].kind != raytpu::Value::Kind::Array)
    throw std::runtime_error("SortInts expects one list argument");
  std::vector<int64_t> xs;
  for (const auto& v : *args[0].arr) xs.push_back(raytpu::ValueTo<int64_t>(v));
  std::sort(xs.begin(), xs.end());
  raytpu::ValueVec out;
  for (int64_t x : xs) out.push_back(raytpu::Value::I(x));
  raytpu::ValueMap m;
  m.emplace("sorted", raytpu::Value::A(std::move(out)));
  m.emplace("n", raytpu::Value::I(static_cast<int64_t>(xs.size())));
  return raytpu::Value::M(std::move(m));
}
RAYTPU_REMOTE(SortInts);

int64_t Boom(int64_t) {
  throw std::runtime_error("cpp kaboom");
}
RAYTPU_REMOTE(Boom);

}  // namespace

namespace raytpu {
int WorkerMain();
}

int main() { return raytpu::WorkerMain(); }
