// An IF conditional node in the CUDA graph being captured on a stream: the
// port's counterpart of the reference's `lax.cond`, decided on the device.
//
// The captured rollout (models/graphed.py) captures each branch of the step
// (the recovery R, the keyframe segment C) as a graph of its own, then
// captures the frame. Where the frame reaches a branch, vo_graph_if_node
//   1. creates a conditional handle on the frame's graph,
//   2. launches a one-thread kernel that sets the handle from a bool that the
//      frame computed on the device (the predicate), captured as a node,
//   3. adds an IF node after it, with the branch's graph cloned into the
//      node's body as a child graph,
//   4. makes the IF node the capture's only dependency, so the frame's next
//      captured work runs after the branch, taken or not.
// At each replay the branch runs only where the predicate is true; nothing
// is read on the host. (Some PyTorch builds have CUDAGraph.
// begin_capture_to_if_node for the same; PyTorch 2.11 built for CUDA 12.8
// has no such method.)
//
// Conditional nodes need CUDA 12.4 (a body may hold child graphs, kernels,
// memsets and memcpys); CUDA 13 renamed the edge-data forms of the capture
// calls, hence the two spellings below.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps, size_t* n) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, nullptr, n);
#else
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, n);
#endif
}

}  // namespace

// stream: the capturing stream; pred: a device bool; branch: the cudaGraph_t
// to run under it. On success *if_node gets the IF node and *body its body
// graph (which holds the clone): libcuda 580 has no call that
// reads a conditional node's bodies back (no cuGraphNodeGetParams), so
// whoever reads the graph's nodes keeps them.
// Returns a cudaError_t, or -1 when the stream is not capturing.
extern "C" int vo_graph_if_node(void* stream_, const void* pred, void* branch, void** if_node,
                                void** body) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(stream, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return -1;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_condition_kernel<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = capture_info(stream, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t if_body = params.conditional.phGraph_out[0];
  cudaGraphNode_t child;
  err = cudaGraphAddChildGraphNode(&child, if_body, nullptr, 0,
                                   static_cast<cudaGraph_t>(branch));
  if (err != cudaSuccess) return (int)err;
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  *if_node = node;
  *body = if_body;
  return 0;
}
