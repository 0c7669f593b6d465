// G1: a loop whose trip count the data decides, inside a CUDA graph.
//
// The reference runs a nested solve as a lax.while_loop inside the outer
// solver's compiled loop (linops_tpu/ops/linalg_ops.py: "the inner solve is
// pure jnp"), so the inner loop stops on the device. Here an outer solver
// iteration is captured into a CUDA graph (utils/loop.py), and a solve nested
// in it becomes a conditional WHILE node (CUDA 12.3 and later): the node runs
// its body graph while its condition is nonzero, and the condition is set on
// the device by set_while_condition_kernel, once before the node (the loop's
// first test) and at the end of each run of the body (the test after it).
// Nothing is read on the host.
//
// The host half adds the node to the graph the stream is capturing and
// captures the body into the node's body graph:
//   linops_while_handle      a condition handle of the graph being captured
//   linops_while_condition   launches the kernel: condition = act
//   linops_while_node_begin  adds the node after the stream's current
//                            dependencies, makes it the stream's only
//                            dependency, and begins capturing a second stream
//                            into the node's body graph (returned, so its
//                            kernel nodes can be listed)
//   linops_while_node_end    ends that capture
// The caller routes the body stream's allocations to a private memory pool
// while it captures (utils/loop.py, kernels/graph_cond.py).
//
// The kernel is one thread: it reads one byte and writes the condition. Its
// time is a launch's inside a graph; there is nothing to bound but latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bsr_common.cuh"  // linops_cuda_error_string

namespace {

__global__ void set_while_condition_kernel(cudaGraphConditionalHandle handle,
                                           const uint8_t* act) {
  cudaGraphSetConditional(handle, act[0] != 0 ? 1u : 0u);
}

// The graph `stream` is capturing into, and its current dependencies.
cudaError_t capturing(cudaStream_t stream, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                      size_t* ndeps) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, &id, graph, deps, ndeps);
  if (e != cudaSuccess) return e;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess : cudaErrorStreamCaptureImplicit;
}

}  // namespace

extern "C" {

int linops_while_handle(int64_t stream, uint64_t* handle) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t e = capturing(reinterpret_cast<cudaStream_t>(stream), &graph, &deps, &ndeps);
  if (e != cudaSuccess) return e;
  cudaGraphConditionalHandle h;
  e = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  *handle = static_cast<uint64_t>(h);
  return e;
}

int linops_while_condition(uint64_t handle, const void* act, int64_t stream) {
  set_while_condition_kernel<<<1, 1, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle), static_cast<const uint8_t*>(act));
  return cudaGetLastError();
}

int linops_while_node_begin(int64_t stream, uint64_t handle, int64_t body_stream,
                            void** body_graph) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t e = capturing(s, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = static_cast<cudaGraphConditionalHandle>(handle);
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return e;
  *body_graph = params.conditional.phGraph_out[0];
  return cudaStreamBeginCaptureToGraph(reinterpret_cast<cudaStream_t>(body_stream),
                                       params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

int linops_while_node_end(int64_t body_stream) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(reinterpret_cast<cudaStream_t>(body_stream), &graph);
}

}  // extern "C"
