// CUDA-graph conditional (IF) nodes for the streaming step's branches.
//
// The JAX step branches with lax.cond, and XLA runs only the taken branch
// (tempestsdr_tpu/stream/pipeline.py: the FFT round, each emit slot, the
// sync-skip shift). The port captures K blocks of its step into one CUDA
// graph (stream/graph.py); inside a capture each branch becomes a pair of
// IF nodes, one run when the predicate holds and one when it does not, so a
// replay runs only the taken body, as XLA does.
//
// The driver evaluates an IF node's condition from a handle that a kernel of
// the same graph sets. So a branch captures, on the capturing stream:
//
//   set_conditional_kernel (one thread): reads the 0-d bool predicate and
//     sets the "taken" handle to pred and the "not taken" handle to !pred;
//   IF node (taken handle): its body graph is captured by a second stream
//     (cudaStreamBeginCaptureToGraph) while the Python side runs the body;
//   IF node (not-taken handle): the same for the other body, which writes
//     into the taken body's outputs. A branch whose untaken side writes
//     nothing (the taken body works in place) has neither this node nor
//     its handle: instantiation refuses a handle without a node.
//
// The predicate is read by the set kernel before either body runs, so a
// body may rewrite the predicate's memory. A body may hold kernel, memcpy,
// memset, empty and conditional nodes; no host node, event node or memory
// allocation node (the Python side allocates a body's tensors from a
// caching-allocator pool of its own, so no allocation node is made).
//
// Bound: each branch costs one one-thread kernel node and up to two
// conditional nodes on the graph's path; what it saves is the body not
// taken. Nothing here moves data.
//
// Built like the kernels beside it (kernels/build.py, nvcc for sm_90a, a
// plain C interface loaded with ctypes); the runtime API forms of CUDA 12.4
// and 13 both compile.

#include <cuda_runtime.h>

__global__ void set_conditional_kernel(cudaGraphConditionalHandle taken,
                                       cudaGraphConditionalHandle not_taken, int with_else,
                                       const unsigned char* pred) {
  const unsigned int p = *pred != 0;
  cudaGraphSetConditional(taken, p);
  if (with_else) cudaGraphSetConditional(not_taken, 1u - p);
}

static cudaError_t capture_graph(cudaStream_t stream, cudaGraph_t* graph,
                                 const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph, deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph, deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorStreamCaptureUnmatched;
}

// Makes the branch's handles in the graph `stream` captures and captures the
// set kernel on `stream`: handles[0] is the taken handle, handles[1] the
// not-taken one, made only when with_else != 0. Returns a cudaError_t (0 =
// ok).
extern "C" int tsdr_cond_handles(void* stream, const void* pred, int with_else,
                                 unsigned long long* handles) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_graph(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle h[2] = {0, 0};
  for (int i = 0; i < (with_else ? 2 : 1); ++i) {
    err = cudaGraphConditionalHandleCreate(&h[i], graph, 0, 0);
    if (err != cudaSuccess) return (int)err;
  }
  set_conditional_kernel<<<1, 1, 0, s>>>(h[0], h[1], with_else, (const unsigned char*)pred);
  err = cudaGetLastError();
  handles[0] = h[0];
  handles[1] = h[1];
  return (int)err;
}

// Adds an IF node on `handle` after what `stream` has captured so far, makes
// the node the stream's capture dependency, and starts capturing
// `body_stream` into the node's body graph (returned in *body). Returns a
// cudaError_t (0 = ok).
extern "C" int tsdr_cond_begin(void* stream, unsigned long long handle, void* body_stream,
                               void** body) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_graph(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = (cudaGraphConditionalHandle)handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err == cudaSuccess)
    err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                              cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err == cudaSuccess)
    err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body_graph = params.conditional.phGraph_out[0];
  err = cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream, body_graph, nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  *body = (void*)body_graph;
  return (int)err;
}

// A stream of the caller's own to capture bodies on, on `device`: not one of
// torch's pooled streams, which it hands out round-robin, so a pooled one may
// be the stream the parent graph is captured on. Returns a cudaError_t.
extern "C" int tsdr_stream_create(int device, void** stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = nullptr;
  err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *stream = (void*)s;
  return (int)err;
}

extern "C" int tsdr_stream_destroy(void* stream) {
  return (int)cudaStreamDestroy((cudaStream_t)stream);
}

// Ends the capture of a body begun by tsdr_cond_begin. Returns a cudaError_t.
extern "C" int tsdr_cond_end(void* body_stream) {
  cudaGraph_t graph = nullptr;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &graph);
}
