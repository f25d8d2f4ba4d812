// CUDA-graph conditional nodes for a capture under way: the port's lax.cond
// (an IF node), lax.while_loop and lax.scan (a WHILE node) in one graph
// (loam_tpu_torch/program.py).
//
// loam_if_begin / loam_while_begin add, to the graph that `stream` is
// capturing, a kernel node that copies the device flag `pred` into a new
// conditional handle and after it a conditional node on that handle, make
// the conditional node what the stream's next work depends on, and start
// capturing `body_stream` into the node's body graph. Whatever is enqueued on
// `body_stream` until the matching *_end runs at a replay only where the flag
// holds when the node is reached; a WHILE body runs again as long as the
// handle holds after it, and loam_while_end makes the body's last node a
// kernel that copies `pred` (which the body updates) into the handle. `stream`
// may itself be a body stream: conditional nodes nest, one body stream a
// depth. The *_end calls return the body graph's node count (nested bodies
// not included: each counts its own), loam_capture_nodes that of the graph a
// stream is capturing. The runtime calls need CUDA 12.4 or later
// (conditional nodes, capture into a given graph); an older runtime or driver
// returns its error here, and the caller raises.

#include <cuda_runtime.h>

__global__ void loam_set_condition_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int loam_stream_create(cudaStream_t* out) {
  return (int)cudaStreamCreateWithFlags(out, cudaStreamNonBlocking);
}

static int conditional_begin(cudaGraphConditionalNodeType type, const void* pred,
                             cudaStream_t body_stream, cudaGraphConditionalHandle* handle,
                             cudaStream_t stream) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureImplicit;
  err = cudaGraphConditionalHandleCreate(handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  loam_set_condition_kernel<<<1, 1, 0, stream>>>(*handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the conditional node depends on what the stream's next work would: the kernel
  err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = *handle;
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(body_stream, params.conditional.phGraph_out[0], nullptr,
                                            nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

static int body_end(cudaStream_t body_stream, size_t* nodes) {
  cudaGraph_t body;
  cudaError_t err = cudaStreamEndCapture(body_stream, &body);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGraphGetNodes(body, nullptr, nodes);
}

extern "C" int loam_if_begin(const void* pred, cudaStream_t body_stream, cudaStream_t stream) {
  cudaGraphConditionalHandle handle;
  return conditional_begin(cudaGraphCondTypeIf, pred, body_stream, &handle, stream);
}

extern "C" int loam_if_end(cudaStream_t body_stream, size_t* nodes) {
  return body_end(body_stream, nodes);
}

extern "C" int loam_while_begin(const void* pred, cudaStream_t body_stream,
                                unsigned long long* handle, cudaStream_t stream) {
  cudaGraphConditionalHandle h;
  int err = conditional_begin(cudaGraphCondTypeWhile, pred, body_stream, &h, stream);
  *handle = (unsigned long long)h;
  return err;
}

extern "C" int loam_while_end(const void* pred, unsigned long long handle, cudaStream_t body_stream,
                              size_t* nodes) {
  loam_set_condition_kernel<<<1, 1, 0, body_stream>>>((cudaGraphConditionalHandle)handle,
                                                     static_cast<const bool*>(pred));
  cudaError_t launched = cudaGetLastError();
  // the capture ends either way: a body left capturing would poison its stream
  int err = body_end(body_stream, nodes);
  return launched != cudaSuccess ? (int)launched : err;
}

extern "C" int loam_capture_nodes(cudaStream_t stream, size_t* nodes) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureImplicit;
  return (int)cudaGraphGetNodes(graph, nullptr, nodes);
}
