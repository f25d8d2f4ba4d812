// CUDA-graph IF nodes for a capture under way: the port's lax.cond /
// lax.while_loop in one graph (loam_tpu_torch/program.py).
//
// loam_if_begin adds, to the graph that `stream` is capturing, a kernel node
// that copies the device flag `pred` into a conditional handle and after it
// an IF node on that handle, makes the IF node what the stream's next work
// depends on, and starts capturing `body_stream` into the IF node's body
// graph. Whatever is enqueued on `body_stream` until loam_if_end runs at a
// replay only where the flag holds when the node is reached. The runtime
// calls need CUDA 12.4 or later (conditional nodes, capture into a given
// graph); an older runtime or driver returns its error here, and the
// caller raises.

#include <cuda_runtime.h>

__global__ void loam_set_condition_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int loam_stream_create(cudaStream_t* out) {
  return (int)cudaStreamCreateWithFlags(out, cudaStreamNonBlocking);
}

extern "C" int loam_if_begin(const void* pred, cudaStream_t body_stream, cudaStream_t stream) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  loam_set_condition_kernel<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the IF node depends on what the stream's next work would: the kernel
  err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(body_stream, params.conditional.phGraph_out[0], nullptr,
                                            nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int loam_if_end(cudaStream_t body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture(body_stream, &body);
}
