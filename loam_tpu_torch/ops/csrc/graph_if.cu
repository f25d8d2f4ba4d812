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
// not included: each counts its own) and its width, loam_capture_nodes and
// loam_capture_width those of the graph a stream is capturing. A graph's
// width is its widest fork: the most nodes that depend on one node, or its
// root nodes where they are more (1 for a chain).
//
// loam_fork / loam_join fork work off a stream onto others and join it back
// (program.branches): loam_fork makes each of `to` wait for what `from` has
// enqueued, and loam_join makes `into` wait for what each of `from` has
// enqueued, through an event each. Under capture that joins the branch
// streams to the capture (of the graph or of a conditional node's body) and
// their work lands in it as parallel branches, edges and no event node; the
// branches then start from exactly `from`'s dependencies, `into` continues
// from the branches' ends alone, and loam_join returns how many they are.
// Eagerly it is stream order on the card. A stream that joined a capture
// stays in it until the capture ends, so the caller forks onto other
// streams in a conditional node's body than in the graph around it. The runtime calls
// need CUDA 12.4 or later
// (conditional nodes, capture into a given graph); an older runtime or driver
// returns its error here, and the caller raises.

#include <cuda_runtime.h>

#include <algorithm>
#include <vector>

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

static cudaError_t graph_width(cudaGraph_t graph, size_t* width) {
  size_t roots = 0, count = 0;
  cudaError_t err = cudaGraphGetRootNodes(graph, nullptr, &roots);
  if (err != cudaSuccess) return err;
  err = cudaGraphGetNodes(graph, nullptr, &count);
  if (err != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> nodes(count);
  err = cudaGraphGetNodes(graph, nodes.data(), &count);
  if (err != cudaSuccess) return err;
  size_t widest = roots;
  for (cudaGraphNode_t node : nodes) {
    size_t out = 0;
    err = cudaGraphNodeGetDependentNodes(node, nullptr, &out);
    if (err != cudaSuccess) return err;
    if (out > widest) widest = out;
  }
  *width = widest;
  return cudaSuccess;
}

static int body_end(cudaStream_t body_stream, size_t* nodes, size_t* width) {
  cudaGraph_t body;
  cudaError_t err = cudaStreamEndCapture(body_stream, &body);
  if (err != cudaSuccess) return (int)err;
  err = cudaGraphGetNodes(body, nullptr, nodes);
  if (err != cudaSuccess) return (int)err;
  return (int)graph_width(body, width);
}

extern "C" int loam_if_begin(const void* pred, cudaStream_t body_stream, cudaStream_t stream) {
  cudaGraphConditionalHandle handle;
  return conditional_begin(cudaGraphCondTypeIf, pred, body_stream, &handle, stream);
}

extern "C" int loam_if_end(cudaStream_t body_stream, size_t* nodes, size_t* width) {
  return body_end(body_stream, nodes, width);
}

extern "C" int loam_while_begin(const void* pred, cudaStream_t body_stream,
                                unsigned long long* handle, cudaStream_t stream) {
  cudaGraphConditionalHandle h;
  int err = conditional_begin(cudaGraphCondTypeWhile, pred, body_stream, &h, stream);
  *handle = (unsigned long long)h;
  return err;
}

extern "C" int loam_while_end(const void* pred, unsigned long long handle, cudaStream_t body_stream,
                              size_t* nodes, size_t* width) {
  loam_set_condition_kernel<<<1, 1, 0, body_stream>>>((cudaGraphConditionalHandle)handle,
                                                     static_cast<const bool*>(pred));
  cudaError_t launched = cudaGetLastError();
  // the capture ends either way: a body left capturing would poison its stream
  int err = body_end(body_stream, nodes, width);
  return launched != cudaSuccess ? (int)launched : err;
}

static cudaError_t capture_graph(cudaStream_t stream, cudaGraph_t* graph) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph, nullptr, nullptr);
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess : cudaErrorStreamCaptureImplicit;
}

extern "C" int loam_capture_nodes(cudaStream_t stream, size_t* nodes) {
  cudaGraph_t graph;
  cudaError_t err = capture_graph(stream, &graph);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGraphGetNodes(graph, nullptr, nodes);
}

extern "C" int loam_capture_width(cudaStream_t stream, size_t* width) {
  cudaGraph_t graph;
  cudaError_t err = capture_graph(stream, &graph);
  if (err != cudaSuccess) return (int)err;
  return (int)graph_width(graph, width);
}

extern "C" int loam_event_create(cudaEvent_t* out) {
  return (int)cudaEventCreateWithFlags(out, cudaEventDisableTiming);
}

// What `stream` captures next depends on, copied out (empty when it is not capturing).
static cudaError_t capture_deps(cudaStream_t stream, std::vector<cudaGraphNode_t>* out, bool* capturing) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, &n);
  if (err != cudaSuccess) return err;
  *capturing = status == cudaStreamCaptureStatusActive;
  if (*capturing) out->insert(out->end(), deps, deps + n);
  return cudaSuccess;
}

extern "C" int loam_fork(cudaEvent_t event, cudaStream_t* to, int n, cudaStream_t from) {
  cudaError_t err = cudaEventRecord(event, from);
  for (int i = 0; i < n && err == cudaSuccess; ++i) err = cudaStreamWaitEvent(to[i], event, 0);
  if (err != cudaSuccess) return (int)err;
  // under capture each branch starts from exactly what `from` would: a
  // branch stream that ran an earlier fork of this capture drops its old end
  std::vector<cudaGraphNode_t> deps;
  bool capturing = false;
  err = capture_deps(from, &deps, &capturing);
  for (int i = 0; i < n && err == cudaSuccess && capturing; ++i)
    err = cudaStreamUpdateCaptureDependencies(to[i], deps.data(), deps.size(), cudaStreamSetCaptureDependencies);
  return (int)err;
}

extern "C" int loam_join(cudaEvent_t* events, cudaStream_t* from, int n, size_t* deps, cudaStream_t into) {
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    err = cudaEventRecord(events[i], from[i]);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(into, events[i], 0);
  }
  *deps = 0;
  if (err != cudaSuccess) return (int)err;
  // under capture `into` continues from the branches' ends alone: the fork
  // point they all follow is no edge of its own
  std::vector<cudaGraphNode_t> ends;
  bool capturing = false;
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    std::vector<cudaGraphNode_t> end;
    err = capture_deps(from[i], &end, &capturing);
    for (cudaGraphNode_t node : end)
      if (std::find(ends.begin(), ends.end(), node) == ends.end()) ends.push_back(node);
  }
  if (err != cudaSuccess || !capturing) return (int)err;
  *deps = ends.size();
  return (int)cudaStreamUpdateCaptureDependencies(into, ends.data(), ends.size(), cudaStreamSetCaptureDependencies);
}
