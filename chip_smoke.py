"""Smoke run of the PyTorch/CUDA port (`deeplearning4j_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure raises and exits non-zero:
  1. the card's name and power limit (nvidia-smi); no card -> exit 1;
  2. build every CUDA kernel from the sources in the checkout (nvcc);
  3. each kernel against its plain PyTorch version on the card: first one
     128-key tile of the Hopper forward kernel (B=1, H=1, T=128, D=64,
     bf16, non-causal), then its tile edges (T=1, 127, 129, 193, 257), then
     the main path's shape and edge shapes, with stated tolerances;
  4. the Hopper forward kernel's registers, spills and shared memory (from
     ptxas' log beside the library), its blocks per SM (the occupancy API),
     its HGMMA / UTMALDG / HMMA / WARPGROUP.DEPBAR instruction counts
     (cuobjdump, where the toolkit has it) and ptxas' note if it serialised
     the kernel's wgmma; K1 timed with CUDA events beside its plain
     version, one PyTorch library call computing the same function (a
     yardstick only: the port never calls it) and its bound on an H100 SXM;
  5. the main path at full width: the flash-attention TransformerLM
     (vocab 512, d_model 512, 8 heads, 4 layers, max_len 8192, bf16, random
     weights from a seed) runs one full causal forward at B=4, T=8192 and
     answers a few generate / generate_batch requests, with every kernel
     launch counter set to 0 just before and read just after; then K1 is
     timed at the re-encode shape of generate(use_cache=False) (B=1,
     T=1024), on the card from a torch.profiler trace;
  6. a small-depth f32 copy of the model (same seed) on the card, through
     the kernel, agrees with the same model on the CPU through the plain
     versions; its greedy flash re-encode tokens equal its dense KV-cache
     tokens;
  7. the training kernels (K2 forward with logsumexp, K4 backward dQ, K5
     backward dK/dV) against their plain versions on the card: first single
     tiles of the Hopper kernels (B=1, H=1, T=64 and 128, D=64, bf16, both
     masks), then the tile edges (T=1, 63, 64, 65, 127, 128, 129, 191, 192,
     193, 257; both masks), then the training shape (B=4, T=8192, H=8, D=64,
     bf16, causal) and edge shapes, with stated tolerances;
  8. the kernel reports of K2, K4 and K5 as in phase 4 (the smoke fails
     unless each SASS has wgmma and TMA loads and no mma.sync); each
     training kernel timed with CUDA events beside its plain version, its
     bound and one PyTorch call (a yardstick only): the flash SDPA forward,
     which also returns the logsumexp, for K2; SDPA's backward alone (dq,
     dk, dv together; device time from a torch.profiler trace) for K4 and
     K5;
  9. the training main path at full width: the same TransformerLM
     (learning rate 0.1, momentum 0.9) takes 8 `fit_batch` steps at B=4,
     T=8192 on the shift task y = (x + 1) % 512, with every launch counter
     set to 0 just before and read just after: 4 launches each of K2, K4
     and K5 per step and none of K1; the losses are finite and fall;
 10. a small-depth f32 copy (same seed) trains three steps on the card
     (kernels) and on the CPU (plain versions); losses and parameters agree;
 11. the kernel reports of K3 (the Hopper forward kernel's third mode;
     bf16, D=64 and D=128) as in phase 4 (the smoke fails unless each SASS
     has wgmma and TMA loads and no mma.sync); the ring-attention partial
     (K3) against its plain version on the card: first single heads of 64
     and 128 rows (B=1, H=1, D=64, bf16, both masks), then the tile edges
     (T=1, 63, 64, 127, 128, 129, 191, 192, 193, 257, 385) on hops whose
     causal edge falls on and inside a tile, then the hop shape of T=8192
     over a ring of 4 (B=4, Tq=Tk=2048, H=8, D=64, bf16): the diagonal, a
     visible, a wholly masked and a non-causal hop, and edge shapes (ragged
     T=1025, fp16 D=128, f32);
 12. K4 and K5 with a hop's global offsets and f32 outputs against their
     plain versions on the same hops and edge shapes;
 13. K3, K4 and K5 (f32 outputs) timed on the visible hop beside their
     plain versions, their bounds and one PyTorch call: for K3 flash SDPA's
     forward (aten._scaled_dot_product_flash_attention, which returns o and
     the logsumexp), for K4+K5 SDPA's backward alone (device time, as in
     phase 8); K3 and its yardstick (causal) also on the diagonal hop, and
     K3 on both hops on the card from a torch.profiler trace;
 14. the ring main path at full width: four rank processes on one card
     (cuda:0), rotating K/V through the host over gloo, run
     `ring_self_attention(causal=True, use_flash=True)` on the global B=4,
     T=8192, H=8, D=64 bf16 input, each on its 2048-token chunk, with every
     launch counter set to 0 just before and read just after: (a) without
     grad, 4 launches of K3 per rank; (b) with grad (loss mean(o**2)), 4 of
     K3 and 4 each of K4 and K5 per rank; never K1 or K2. The gathered
     output agrees with the single-card flash attention (K2); the ring's
     gradients and the single card's (K2, K4, K5) each agree with the f32
     plain gradient, within limits that the same gradient from an o one
     bit coarser than bf16 fails; an f32 ring (T=1024) on the card agrees
     with the same ring on the CPU. The ranks also run the
     sequence-parallel `SelfAttentionLayer` (d_model 512, 8 heads, causal,
     a key mask with padding in every row; f32, the einsum ring), each on
     its chunk of B=2, T=1024, held against the local layer's slice of the
     same output.
     With four cards it runs again over NCCL, one rank per card; with fewer
     it says that it skipped that step.
Phases 15-18 drive the DL4J training core (MultiLayerNetwork,
ComputationGraph, the model zips), whose path reaches none of the port's
kernels: cuDNN and cuBLAS run it, as XLA runs it for the JAX package. The
launch counters are set to 0 before them and must read 0 after. They run
with PyTorch's default `cudnn.allow_tf32 = True`: the port turns TF32 off
for its float32 networks inside its own calls.
 15. LeNet (MultiLayerNetwork, f32, batch 64, seeded weights): `output` and
     three Nesterov `fit` steps on the card and on the CPU; losses and
     parameters agree;
 16. ResNet-50 (ComputationGraph) at full depth, 64x64x3, batch 2, 10
     classes, f32: `output` and the first training loss, card against CPU
     (and, as controls that must break the limits, both with TF32 on);
     then two `fit` steps on the card, on the CPU and in float64 on
     the CPU: the card's parameter change is no more than twice as far
     (relative L2) from float64's as the CPU's f32 is (at batch 2 this
     deep BatchNorm net is ill-conditioned in f32: ~5%);
 17. ResNet-50 at full width: `resnet50(data_type="bfloat16")`, batch 128,
     224x224x3, 1000 classes, Nesterov lr 0.1, momentum 0.9, one repeated
     random batch on the card (as the JAX package's bench.py): 24 warm-up
     steps (cuDNN's algorithm search runs there, and the loss's early rise
     and fall; the last one is audited: every op of the step on the card),
     then 8 `fit` steps timed by CUDA events: finite losses, the last
     below the first, step ms, images/s
     and peak memory; f32 master parameters on the card; a timed `output`
     at batch 128; the device time of one step by kernel, from a
     torch.profiler trace;
 18. the golden model zips (tests/fixtures/golden/{mlp,lenet,lstm,cg}.zip)
     restored on the card: parameters equal, outputs as the zips' io["y"].
Phases 19-21 drive the data and serving path (no port kernel either; the
counters must still read 0 after them):
 19. LeNet f32 over iterators: three `fit` steps on MnistDataSetIterator
     (batch 64, synthetic) with NormalizerMinMaxScaler, through an
     AsyncDataSetIterator with one and then two workers, on the card and
     on the CPU: parameters agree; then `evaluate` on a test iterator:
     confusion matrices equal, accuracy, precision, recall and F1 agree;
 20. ResNet-50 bf16 at full width (phase 17's warmed network) `fit` over
     a host iterator: uint8 NHWC batches of 128x224x224x3 through
     AsyncDataSetIterator (ImagePreProcessingScaler on the card, the bf16
     wire): a staged batch equals the same bytes put on the card and
     scaled there, bit for bit; 8 steps by CUDA events (images/s beside
     phase 17's), the host-to-device copy of a batch, and from a
     torch.profiler trace of 3 more steps whether the copies run on the
     staging stream while the step's kernels run, and the device's busy
     share; losses finite;
 21. InferenceServer serving ResNet-50 bf16 at 224x224x3 (max_batch 32,
     buckets 2-32, 8 client threads, 256 single-image requests, after
     warm-up traffic through the server's own thread): each bucket's
     dispatch timed by CUDA events; a hot swap to other weights
     mid-stream: nothing dropped, every result equal to its dispatch's row
     under the version that served it; a NaN request fails alone and
     serving goes on; the images served again in other company by the same
     bucket are bit-equal; across buckets, and against `output` of the
     same padded batch on another thread (cuDNN searches its plans per
     thread), within bf16's rounding; request p50/p99 and images/s;
     `swap_from_path` of the golden LeNet zip on a LeNet server (1e-5).
Phase 22 drives the TransformerLM's continuous-batching decode server
(serving/decode.py). Its programs are torch indexing and cuBLAS, as XLA
runs the JAX package's: no kernel of the port, and the counters must read
0 after it. The model is phase 5's (vocab 512, d_model 512, 8 heads, 4
layers, max_len 8192, bf16, seed 0), not cut; traffic from the ported
loadgen, seeded; every server warmed by one bucket-long request per prompt
bucket through its own thread before its traffic:
 22. (1) fixed slots (16 slots, prompt buckets 64/256/1024): the decode
     iteration timed by CUDA events, then 128 requests (prompts 16-1024,
     16-256 new tokens) on a Poisson process at 60% of what the step alone
     could decode: tokens/s, TTFT and inter-token p50/p99, dispatches per
     token; 8 co-batched streams served again alone are bit-equal; the
     same traffic with static_batching=True (continuous over static);
     (2) paged at the fixed arena's bytes (64 slots, 8192 blocks of 16,
     80 blocks a slot), SharedPrefixMix (4 prefixes of 16-32 blocks): the
     most live streams, prefix hits, tokens/s, and the pool checked clean
     with no block in use after; (3) overload: an on/off burst at 3x item
     1's rate of interactive and batch requests, with admission, a
     brownout policy and a 5 s deadline, chunked_prefill=256 against
     one-shot prefill: sheds, deferrals, TTFT p99 by class; (4)
     fused_serve=8, fixed and paged: ceil(iterations/8) dispatches and one
     CUDA graph for a solo request, its stream equal to the plain
     server's; a captured window against 8 plain steps on the same random
     cache, tokens and every cache byte bit-equal, each timed; (5) a hot
     swap to other weights mid-stream: nothing fails, each stream equals
     its version's solo stream in the same server; (6) across layouts and
     shapes (paged vs fixed, chunked vs one-shot, the server vs
     generate_batch; 8 prompts, 32 tokens): equal streams and first
     divergences, and the relative error of the prefill logits (bucket vs
     exact length) and of the first step's logits (paged vs fixed) -
     measured, not pinned.
Phase 23 drives the recurrent path: BASELINE.md configuration #3, the
char-RNN (`models/zoo/char_rnn.py`: V=77, two GravesLSTM layers of 200,
RnnOutputLayer, truncated BPTT of 50, RMSProp lr 0.1). Its layers are
eager torch and cuBLAS, as XLA runs the JAX package's `lax.scan`: no kernel
of the port, and the counters must read 0 after it.
 23. (a) f32 and f64 correctness, card against CPU from the same seeded
     weights: the char-RNN at B=8, T=120 (segments of 50, 50 and 20),
     three `fit` calls with SGD in f32 and with its RMSProp in f64: every
     segment's score and the final parameters; then `rnn_time_step` over
     20 single steps against `output` of the same 20 steps; one
     GravesBidirectionalLSTM and one causal SelfAttentionLayer forward
     with a [B, T] mask that pads every row; (b) full width, bf16, as the
     JAX package's bench.py runs it: B=64, T=200, one repeated one-hot
     batch from the seed, 3 warm-up `fit`s, then 20 timed by CUDA events:
     chars/s, ms per fit and per segment, peak memory, the losses (finite,
     the last below the first); a torch.profiler trace of one fit: device
     time by kernel kind, the device's busy share, launches per segment;
     then the DL4J char example's streaming: `rnn_time_step` over a
     50-char primer and 200 single greedy steps at batch 64, ms per step.
Phase 24 drives the embeddings path: BASELINE.md configuration #4,
Word2Vec / ParagraphVectors skip-gram with negative sampling
(`models/embeddings/learning.py`, `sequencevectors/`, `word2vec/`,
`paragraphvectors/`, `glove/`), pairs from the native generator
(native/dl4j_tpu_native.cpp through `common/native_ops.py`; the phase fails
without it). Its steps are torch gathers, batched products and a
deterministic scatter-add, one CUDA graph a flush shape, as XLA runs the
JAX package's `lax.scan`: no kernel of the port, and the counters must read
0 after it.
 24. (a) f32, card against CPU from the same numpy tables and pair arrays
     (V=10,000 words with counts zipf(1.5), D=100, window 5): one flush of
     skip-gram with negative sampling at 65,536 and at 4,096 pairs, of
     skip-gram with hierarchical softmax (T = the longest Huffman code) and
     of CBOW, each within 1e-5, its chunks checked to repeat ids, and on
     the card graph == its rerun == eager, bit for bit; one GloVe AdaGrad
     batch of 8,192 co-occurrence entries, 1e-5, two card runs bit-equal;
     then the JAX package's toy fits on the card (tests/test_word2vec.py's
     corpus): Word2Vec skip-gram HS and negative, CBOW (the cluster pin:
     intra > inter + 0.2, the nearest words in the cluster), ParagraphVectors
     DBOW (document clusters) and DM (`infer_vector`), GloVe, each through
     the serializer and back; (b) config 4 at full width as bench.py runs
     it: sequences of 40 random ids through the native corpus route (256
     a call), arms of 65,536 and 4,096 pairs a flush, each as a CUDA graph
     and eager, 3 interleaved segments of 640 sequences after 100, every
     arm on the same chunk: pairs/s (median, best), ms a flush, a
     torch.profiler trace of one segment's full flushes (device time, busy
     share, kernels a flush), peak memory, and graph and eager tables
     bit-equal at the end; then `SequenceVectors.fit` once at full width.
Phase 25 drives data-parallel and parameter-server training, BASELINE.md
configuration #5 (`chip_parallel.py` runs it alone). Phase 26 drives fused
steps and the training-health watchdog (`nn/fused.py`, `common/health.py`,
`util/sharded_checkpoint.py`; `chip_fused.py` runs it alone): a fused group
of K steps is one CUDA graph replay; no kernel of the port, and the
counters must read 0 after it.
 26. (c) fused_steps(8) bit-equal to single steps on small nets on the
     card (parameters, updater and layer state, every step's score,
     iteration_count): exponential and schedule-map learning rates over two
     groups, dropout, a fresh net's first group, TBPTT groups at t0 = 0 and
     8 from one capture; f32 LeNet fused8 card vs CPU on phase 15's batch
     (1e-5), and measured on fresh batches beside the CPU against itself
     from one weight moved by 1e-7; (d) the watchdog on the card: a NaN at
     inner step 3 of a group of 8 skipped as the sequential run skips it, a
     divergence mid-group rolled back through the checkpoints (restored
     round 4, the group's last batches replayed, equal to the run without
     the poisoned batches), an abort naming its rounds, and the one-rank
     ParallelWrapper's rollback in both modes (restored round 5,
     iteration_count 7, bit-equal to the run without the poisoned batch);
     (a) BASELINE config 1 as bench.py runs it: LeNet bf16, batch 512, 16
     batches a fit, fused8 against fused1, 5 interleaved segments an arm
     (images/s, median; peak memory; 2 replays a fit), both arms bit-equal,
     one group and one single step traced (kernels, device time, busy
     share); (b) config 3: the char-RNN bf16 at B=64, T=200, TBPTT 50, 20
     timed fits an arm in interleaved blocks of 5 (chars/s, peak memory; 1
     replay a fit), both arms bit-equal, one fit of each traced.
Phase 27 drives the last of bench.py's configurations (`chip_spec_kv.py`
runs it alone): ResNet-50 with segment remat (`nn/graph/computation_graph.py`,
`torch.utils.checkpoint`), speculative decoding (`serving/speculate.py`, the
verify programs) and durable KV state (preemption, migration, the prefix
cache on disk; `serving/kvstate.py`, `make_block_extract_fn`). None of it
reaches a kernel of the port: the counters are set to 0 first and must read
0 after it, apart from 27(b)'s teaching steps, which run the flash training
kernels and are counted apart.
 27. (a) BASELINE config 2 with remat as bench.py's resnet50_remat runs it:
     first the pins, under cuDNN's deterministic algorithms: phase 16's f32
     64x64 ResNet-50 at batch 2, remat against plain over 2 steps (scores
     rtol 1e-5, parameters 2e-5, the reference's bounds); remat with
     fused_steps(2) == 4 single remat steps bit for bit (2 graph replays);
     the reference test's residual graph with input dropout 0.7, remat
     fused2 == plain single steps bit for bit. Then bf16, batch 128,
     224x224x3, Nesterov lr 0.1, one batch on the card: 2 steps of each
     arm from the same weights under the deterministic algorithms, their
     largest parameter difference held to 2^-8 of the largest parameter
     change; the same under the timed search, measured beside two plain
     nets' difference (a searched algorithm may not be deterministic);
     then 4 interleaved segments
     of 4 steps an arm by CUDA events (ms a step and images/s, median),
     the peak memory over what was held before each step, one traced step
     of each; (b) phase 22's model (bf16), first taught short cycles by
     150 fit_batch steps of 16 x 128 tokens at lr 0.05 (bench.py:743-752
     teaches at 0.3 in f32; bf16 diverges there), served a
     closed-loop schedule of 64 cyclic prompts (bench.py:754-762's shape)
     by Speculator(NGramDraft(n=3), k=4) and by the plain server, fixed
     (16 slots) and paged (DS_PAGED): tokens/s, dispatches/token, accepted
     tokens a slot-dispatch, TTFT and inter-token p50/p99, one verify
     dispatch by CUDA events and traced, join == solo on 8 streams inside
     the speculative server (pinned), the share of streams equal to the
     plain server's and of paged equal to fixed (measured: bf16 gemm bits
     change with M); a ModelDraft of the model itself, 4 slots, 8
     requests; (c) durable KV: preemption against shed-only at full block
     occupancy (tools/serve_ab.py's shape: a 40-block pool of 16 rows, 4
     slots, batch requests of 9+312 tokens, 8 interactive 4-token requests
     a segment with a 100 ms deadline, 2 segments an arm): interactive
     goodput within the deadline, preempted / resumed / spill bytes, ms to
     extract, copy and install a slot; each preempted batch stream equal
     to the same request served alone by the same server, the pools clean;
     migration between two DS_PAGED servers mid-stream (the stream equal to
     the first server's solo stream, the fingerprints equal); the prefix
     cache saved to a directory under build/ and restored by a new server
     with prefix_cache_dir= (restored rows hit, streams equal to the saving
     server's; bytes written, save and restore ms). Every artifact is bf16,
     read and written without ml_dtypes.
 28. the fleet and the wire on phase 22's model (`fleet_phase`, alone:
     chip_fleet.py): in-process paged replicas behind a FleetManager
     against bare servers, a severed replica, a drain, canary rollouts,
     then 2 replica processes behind the wire; the flash counters read 0.
 29. the training tools, the containers' surface and the classic CNNs
     (`tools_phase`, alone: chip_tools.py), under cuDNN's deterministic
     algorithms wherever two runs must be bit-equal: (a) predict, get_layer
     and n_layers on LeNet bf16; (b) config #1's width (LeNet bf16, batch
     512, 16 batches a fit): PerformanceListener's samples/s beside CUDA
     events recorded at the same calls, and fused_steps(8) with and without
     a CollectScoresIterationListener (images/s in interleaved fits; the
     listener's scores equal to the groups' per-step scores; both nets
     bit-equal); (c) early stopping: LocalFileModelSaver under build/ with
     ScoreImprovement(2) and MaxEpochs(5), the best model's zip restored on
     the card with outputs bit-equal to the net's at its best epoch;
     EarlyStoppingParallelTrainer over the one-rank wrapper, k = 1 and 2,
     bit-equal to EarlyStoppingTrainer; TpuEarlyStoppingTrainer over the
     TrainingMaster; ShardedModelSaver's best model bit-equal; (d)
     check_gradients on cuda:0 for tier-1's f64 conv + max-pool net and
     GravesLSTM with masks; (e) the solvers, 10 iterations, card against
     CPU (1e-8 relative), and LBFGS at 100 iterations below 0.3; (f)
     ProfilerListener on ResNet-50 bf16, batch 128, 3 steps after 5, then
     summarize_trace: its top rows and device ms a step beside the step by
     CUDA events; (g) AlexNet and GoogLeNet at batch 128, VGG-16 at 64,
     224x224x3, 1000 classes, bf16: one forward, 4 steps on fresh batches
     (finite losses; ms a step and images/s by CUDA events, the median of
     the last 3; peak memory; one traced step), then toy copies card
     against CPU (an f32 forward, an f32 and an f64 step); (h)
     graft_entry.entry()'s forward, timed. The flash counters read 0.
 30. layerwise pretraining and Keras import (`python3 chip_pretrain.py`
     alone): (a) the MNIST deep autoencoder of DL4J's DeepAutoEncoderExample
     (RBMs 784-1000-500-250-100-30-100-250-500-1000, a sigmoid MSE
     OutputLayer 1000 -> 784, f32, batch 1000, the synthetic MNIST
     stand-in): `pretrain` over 3 batches a layer (layer 0's reconstruction
     error must fall), each layer's pretrain step timed (ms, images/s), two
     traced by the port's profiler (device ms, busy share), then `fit` over
     ReconstructionDataSetIterator (ms, images/s, busy share), peak memory;
     (b) the same with denoising AutoEncoders (corruption 0.3); (c)
     VaeMNIST2dPlots' VAE (784 -> [256, 256] -> 2 -> [256, 256], Bernoulli,
     leakyrelu, RMSProp 1e-3, batch 128): pretrained over 8 batches (the
     negative ELBO on a fixed batch and eps must fall), then
     reconstruction_probability (16 samples) and generate_at_mean_given_z
     on a 20x20 grid of z; (d) Keras import on the card (no h5py there):
     the committed real fixture from tests/fixtures/
     keras_toy_residual_torch.npz within 1e-5 of Keras's predictions, and
     tier-1's Keras 1 MLP, th conv, LSTM and functional nets card against
     CPU (1e-5); then an RBM (CD-1), a gaussian RBM (CD-2), an AutoEncoder
     and a VAE pretrained in float64 on the card and on the CPU with the
     same draws: parameters and score within 1e-9. The flash counters read
     0.
 31. model parallelism (`python3 chip_model_parallel.py` alone): 4 gloo
     rank processes on cuda:0 (and, where four cards are present, (a) once
     more over NCCL, one rank a card): (a) GPipe over four flash
     TransformerLM stages at bench.py's width, bf16, T=8192, 4 microbatches
     of one row: K2, K4 and K5 launched exactly 21 times per rank over 3
     `fit_batch` steps and K1 7 times per `forward`; the first step's loss
     and stage gradients against the four blocks run in order in this
     process through the same kernels (bf16 limits: loss 5e-3 relative,
     gradients 2e-2 relative L2); step time, the rotations' spans in an
     instrumented step (their share of it) and a lone rotation's time, a
     traced step's device time (busy share of the card), peak
     memory per rank; f32 at T=1024 on the card against the CPU's plain
     versions (1e-5); (b) Megatron blocks at d_model 512, 8 heads (4 a
     rank), d_ff 2048 on (data 1, model 2, pipe 2), T=1024: loss and
     gradients against the dense blocks in f32 (1e-5) and bf16, then 10
     steps (the loss falls); (c) experts E=8 over 4 ranks, d_model 512,
     d_ff 2048, 4,096 tokens: sharded against dense at k=1, 2, with and
     without a capacity that drops, dp x ep top-2, a MoE block's step
     (1e-5, expert ids equal); (d) LeNet with Adam at batch 128 through
     the wrapper's tensor parallelism (each split layer computing its
     columns) and sharded updater state on (data 2, model 2) against the
     replicated run (1e-5), each rank holding half (a quarter) of every
     split leaf, `lower_step`'s footprint, each rank's FLOPs counted over
     one step (FlopCounterMode) against data parallelism's on (data 4)
     and against the replicated step on the same 64 rows (1/2 within 1%),
     a checkpoint saved shard by shard and restored bit-equal into a split
     layout and into one net, `swap_from_checkpoint` into an
     InferenceServer, and its step time and peak memory per rank against
     data parallelism on (data 4); (e) config 4's skip-gram with its tables
     column-sharded over the 4 ranks against the whole tables (1e-5); the
     flash counters read 0 after (b)-(e); (f)
     `graft_entry.dryrun_multichip(4)` on cuda:0 ranks with its budget gate,
     K3 launched once a ring hop (counted apart); K1, K2, K4, K5 held
     against their plain versions and timed at the stage shape (B=1,
     T=8192). Under 120 s.
 32. the training UI and the visualisation tools (`python3 chip_ui.py`
     alone): (a) LeNet f32 batch 64, 20 `fit` steps with a full
     StatsListener (histograms, activation stats armed in the step) bit-equal
     to the same fit without it (cuDNN's deterministic algorithms), each
     reported activation mean and mean magnitude within 1e-5 of
     `feed_forward` on the step's parameters and batch, the grids' heights
     and channels, the legacy listeners; (b) ResNet-50 bf16 at batch 128,
     224x224x3: the step with no listener and with a StatsListener
     reporting every 10 and every step into a SqliteStatsStorage, a
     report's time and host bytes; a UIServer on 127.0.0.1 serves every page
     and /api route from it (200, the session's updates), each timed, and a
     RemoteUIStatsStorageRouter posts into it; VGG-16 bf16 at batch 64 (a
     MultiLayerNetwork: a graph has no activation summaries) with the
     step's summaries disarmed and armed, its step time and peak memory; (c) LeNet through the
     wrapper in all-reduce mode on 4 gloo ranks of cuda:0, armed on every
     rank, the listener on rank 0: the global batch's summaries against
     one process's (1e-5); (d) k-means over config 4's table shape (10,000
     x 100 f32, K 100, up to 100 Lloyd steps) card against CPU from the same
     seed: centers and cost 1e-5, labels equal away from near-ties; (e) the
     dense t-SNE loop at N=4096 card against CPU on the same P and y0 over
     5 iterations (within twice the CPU's f32 loop's distance from its f64
     loop; at 50 the card's f32 vs f64 distance is read: the loop is
     chaotic), 500 iterations timed, `Tsne.fit` on the card; Barnes-Hut at
     N=10,000: `_sparse_sym_p` card against CPU (CSR pattern equal, values
     1e-5), the native forces' share of the fit; every embedding keeps its
     clusters apart (the reference's pin); (f) CSVSequenceRecordReader
     with prefetch=4 over 256 files equal to prefetch=0, rows/s; (g)
     `python -m deeplearning4j_tpu_torch.parallel.main` on the card with
     (b)'s server as its --ui-url: the written zip restores with finite,
     changed parameters and the server holds its session. The flash
     counters read 0 after it.
 33. graph embeddings, streaming and object-store training (`python3
     chip_graph_stream.py` alone): (a) DeepWalk at BlogCatalog's size (the
     DeepWalk paper's first dataset: 10,312 vertices, 333,983 edges, 39
     labels), drawn as a planted partition from a numpy seed (90% of the
     edges inside a community), vector 128, window 10, walk length 40 (the
     paper's d, w, t), one epoch: the walk time (host), `fit`'s time and
     pairs/s, one traced flush's busy share, and the quality pin: over 200
     seeded vertices the 10 nearest share the vertex's community at 5x
     chance or more; (a') a 500-vertex DeepWalk (vector 32, walk 20,
     window 5, 2 epochs) card against CPU (syn0 and syn1 1e-5), two card
     fits bit-equal, save -> load; (b) LeNet f32 at batch 64 under cuDNN's
     deterministic algorithms: 20 DataSets through a
     StreamingTrainingPipeline (score topic) against a `fit` loop on the
     main thread (scores and parameters 1e-5), 20 payloads through a
     StreamingInferencePipeline against `output()` (1e-5); ResNet-50 bf16
     at batch 32, 224x224x3, 8 payloads through the inference pipeline,
     timed, not pinned: per payload the ms to decode, run `output`, encode
     and publish, images/s; (c) `fit(ObjectStoreDataSetIterator)` over 16
     LeNet DataSets in a LocalFSObjectStore bit-equal to the same fit from
     memory; ClusterProvisioner's launch commands start
     `python -m deeplearning4j_tpu_torch.parallel.main` as two ranks
     through LocalCommandRunner: both exit 0 in a world of 2 (gloo on the
     one card), rank 0's zip restores with finite parameters; (d) the
     device-free modules (the Japanese and Korean dictionaries, the POS and
     chunk models, the tree parser, stemming, TF-IDF, the inverted index)
     once each on the committed fixtures. The flash counters read 0 after
     it.
Then it prints a {"training_core": ...} JSON line, a {"data_and_serving":
...} line, a {"decode_serving": ...} line, a {"recurrent": ...} line, an
{"embeddings": ...} line, a {"parallel": ...} line, a {"fused": ...} line,
a {"spec_kv": ...} line, a {"fleet": ...} line, a {"tools": ...} line, a
{"pretrain": ...} line, a {"model_parallel": ...} line, a {"ui": ...}
line, a {"graph_stream": ...} line, one {"kernels":
[...]} JSON line (K1, K2, K4 and K5 with their GPipe launches and stage-shape
times) and, as the last line, {"ok": true, "device": {...}}. It imports
nothing of JAX.
"""
import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from datetime import timedelta
from functools import partial
from pathlib import Path

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16/fp16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FULL = dict(vocab_size=512, d_model=512, n_heads=8, n_layers=4,
            max_len=8192, seed=0, attention="flash")
B, T = 4, 8192
TRAIN_STEPS = 8
LSE_ATOL = 1e-5   # read 1.9e-6 (bf16, T=8192) on an H100
RING = 4          # ranks of the ring main path (phase 14)
HOP_T = T // RING
RING_GROUP_TIMEOUT_S, RING_JOIN_TIMEOUT_S = 60, 300
ATT_T = 1024      # phase 14's sequence-parallel SelfAttentionLayer
# Phase 14: (least atol at rtol 1e-2, max row err) of dq, dk, dv of
# mean(o**2) against the f32 gradient, in units of its rms. Each is 1.5x
# what the single card (K2, K4, K5) and the ring both read on an H100
# (dq 0.4304, 1.509e-2; dk 0.3091, 1.014e-2; dv 0.0707, 2.630e-3); the
# same gradient from an o rounded to 7 significant bits reads dq 1.590,
# dk 1.077 and 2.14e-2, dv 0.1335, over each.
GRAD_LIMITS = {"dq": (0.65, 0.023), "dk": (0.47, 0.016),
               "dv": (0.11, 0.004)}
# Phase 21: ResNet-50 bf16 rows computed on two cuDNN plans (another
# bucket size, or the same shape searched on another thread). bf16 rounds
# every layer's output (2^-8 relative), and two plans' f32 sums round some
# values one step apart: on an H100 a row of pooled features reads up to
# 2.4e-3 and 2.8e-3 (relative L2) across buckets in two runs; the softmax
# turns a logit's change into up to 3.1e-2 of a probability (0 to 3.6e-6
# between threads). The limits: 1e-2 relative for the features, 0.1 for a
# probability.
CROSS_PLAN_RTOL, CROSS_PLAN_ATOL = 1e-2, 1e-1


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, names, iters=100):
    """Mean device time in ms of each kernel whose name holds one of
    `names`, from a torch.profiler trace of `iters` calls of fn after one
    warm-up; None for a kernel that the trace shows no device time for."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = []
    for name in names:
        events = [e for e in prof.key_averages() if name in e.key]
        total_us = sum(e.device_time_total for e in events)
        count = sum(e.count for e in events)
        times.append(total_us / 1e3 / count if total_us and count else None)
    return times


def strided_qkv(b, t, h, d, dtype, seed):
    """q, k, v as the model makes them: [B, T, H, d] views into one
    [B, T, 3*H*d] projection."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, t, 3 * h * d, generator=gen, device="cuda").to(dtype)
    return [a.reshape(b, t, h, d) for a in qkv.split(h * d, -1)]


def flash_plain(fa, q, k, v, causal, scale=None):
    """The plain version one batch row at a time: at T=8192 its f32 scores
    take 2.1 GB per row."""
    return torch.cat([fa.flash_attention_reference(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], causal, scale)
        for i in range(q.shape[0])])


def compare(label, got, want, atol, rtol, row_rtol, row_floor=0.0):
    """Element-wise |err| <= atol + rtol*|plain|, and per row (last axis:
    one query or key, one head) ||err|| <= row_rtol*||plain|| + row_floor:
    most outputs are far smaller than 1, so the row check is the one that
    sees an error of a few percent (e.g. padded keys of a ragged tile left
    unmasked). The printed row error is ||err|| / (||plain|| +
    row_floor/row_rtol). Returns the max abs error."""
    diff = got.float() - want.float()
    err = diff.abs()
    max_abs = err.max().item()
    row_err, row_norm = diff.norm(dim=-1), want.float().norm(dim=-1)
    row_rel = (row_err / (row_norm + row_floor / row_rtol).clamp_min(1e-30)
               ).max().item()
    ok = (bool(torch.isfinite(got).all())
          and not (err > atol + rtol * want.float().abs()).any()
          and row_rel <= row_rtol)
    print(f"  {label}: max_abs_err {max_abs:.3e} "
          f"(|err| <= {atol:g} + {rtol:g}*|plain|), max row rel err "
          f"{row_rel:.3e} (<= {row_rtol:g}"
          f"{f', floor {row_floor:g}' if row_floor else ''}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"kernel disagrees with its plain version ({label})")
    return max_abs


def check_flash(fa, label, q, k, v, causal, scale, atol, rtol, row_rtol):
    out = fa.flash_attention(q, k, v, causal, scale)
    want = flash_plain(fa, q, k, v, causal, scale)
    torch.cuda.synchronize()
    return compare(f"flash {label}", out, want, atol, rtol, row_rtol)


def per_row(fn, *args):
    """fn over one batch row at a time, results concatenated: the plain
    versions hold [H, T, T] f32 panels, 2.1 GB each at T=8192."""
    outs = [fn(*(a[i:i + 1] for a in args)) for i in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def shown_ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


def bound(flops, nbytes):
    """(ms, "operations" or "bytes"): the least time an H100 SXM takes."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def hopper_report(_build, label, library, kernel, occupancy):
    """What ptxas, the occupancy API and the SASS say of one Hopper kernel:
    registers, spills and static shared memory from the build log of
    `library`, resident blocks per SM, threads and dynamic shared memory per
    block (`occupancy`, a C entry's arguments before its two out-pointers),
    the count of wgmma (HGMMA), TMA load (UTMALDG), mma.sync (HMMA) and
    wgmma wait (WARPGROUP.DEPBAR) instructions in its SASS where the toolkit
    has cuobjdump, and ptxas' notes when it serialised the kernel's wgmma
    (as many waits as wgmma). `kernel` is a
    regex that picks the instantiation's mangled name. Fails unless the SASS
    has wgmma and TMA loads and no mma.sync. Returns the report as a dict and
    prints it."""
    import ctypes

    def ours(name):
        return re.search(kernel, name) is not None

    fields = {"registers": r"Used (\d+) registers",
              "spill_store_bytes": r"(\d+) bytes spill stores",
              "spill_load_bytes": r"(\d+) bytes spill loads",
              "static_smem_bytes": r"(\d+) bytes smem"}
    report, current = {}, None
    log = _build.log_path(library).read_text()
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1]
        elif current and ours(current):
            for key, pattern in fields.items():
                found = re.search(pattern, line)
                if found:
                    report[key] = int(found.group(1))
    # ptxas' notes where it had to wait after every wgmma of the kernel
    # (C7515: accumulators written in flight; C7512: too few registers)
    notes = [f"{code}: {why}" for code, why, name in re.findall(
        r"\((C75\d\d)\)[^\n]*?wgmma\.mma_async instructions are serialized "
        r"due to (.*?) (?:in|for) the function '(\S+)'", log) if ours(name)]
    if notes:
        report["wgmma_serialized"] = "; ".join(notes)
    symbol, *args = occupancy
    fn = getattr(_build.load(library), symbol)
    fn.argtypes = ([ctypes.c_int] * len(args)
                   + [ctypes.POINTER(ctypes.c_int)] * 2)
    threads, smem = ctypes.c_int(), ctypes.c_int()
    report["blocks_per_sm"] = fn(*args, ctypes.byref(threads),
                                 ctypes.byref(smem))
    report["threads"], report["dynamic_smem_bytes"] = threads.value, smem.value
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(cuobjdump):
        sass = subprocess.run(
            [cuobjdump, "-sass", str(_build.library_path(library))],
            capture_output=True, text=True, timeout=300).stdout
        for part in sass.split("Function : ")[1:]:
            if ours(part.split("\n", 1)[0]):
                report["sass_HGMMA"] = part.count("HGMMA")
                report["sass_UTMALDG"] = part.count("UTMALDG")
                report["sass_HMMA"] = part.count("HMMA.")
                report["sass_WARPGROUP_DEPBAR"] = part.count(
                    "WARPGROUP.DEPBAR")
    else:
        report["sass"] = "cuobjdump not found"
    print(f"  Hopper kernel {label}: {json.dumps(report)}")
    if "registers" not in report or (
            "sass" not in report and "sass_HGMMA" not in report):
        raise SystemExit(f"no kernel matching {kernel} in the build log or "
                         f"the SASS of {library}")
    if (report.get("sass_HGMMA") == 0 or report.get("sass_UTMALDG") == 0
            or report.get("sass_HMMA", 0) > 0):
        raise SystemExit(f"the Hopper kernel {label}'s SASS lacks wgmma or "
                         f"TMA loads, or has mma.sync")
    return report


def fwd_report(fa, _build, mode, d=64):
    """`hopper_report` of the Hopper forward kernel in `mode` (0: K1, 1: K2,
    2: K3, the source's `Mode`), bf16, head dim d."""
    return hopper_report(
        _build, f"K{mode + 1} bf16 D={d}", "flash_attention_fwd",
        rf"flash_fwd_hopper_kernelI13__nv_bfloat16Li{d}ELi{mode}E",
        ("dl4j_flash_fwd_occupancy", fa._DTYPE_CODE[torch.bfloat16], d,
         mode))


def bwd_report(fa, _build, dq):
    """`hopper_report` of K4's (dq True) or K5's Hopper kernel, bf16, D=64,
    outputs in bf16 (the mangled name repeats the type as a substitution)."""
    return hopper_report(
        _build, f"{'K4' if dq else 'K5'} bf16 D=64", "flash_attention_bwd",
        rf"flash_bwd_{'dq' if dq else 'dkv'}_hopper_kernel"
        r"I13__nv_bfloat16S\d*_Li64E",
        ("dl4j_flash_bwd_occupancy", fa._DTYPE_CODE[torch.bfloat16], 64,
         int(dq)))


def sdpa_backward_ms(q, k, v, do, causal, iters=20):
    """Device time in ms of SDPA's flash backward alone (dq, dk, dv together)
    on [B, T, H, D] inputs, from a torch.profiler trace of `iters` forwards
    and backwards: every kernel in the trace but the forward's (flash_fwd).
    Returns (ms or None where the trace shows no device time, {kernel: ms per
    call}). A yardstick only: the port never calls SDPA."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_()
                  for a in (q, k, v))
    gt = do.transpose(1, 2).contiguous()

    def step():
        torch.autograd.grad(sdpa(qt, kt, vt, is_causal=causal), (qt, kt, vt),
                            gt)

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                step()
            torch.cuda.synchronize()
    per_call = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:   # by kernel name, template arguments cut
            name = re.sub(r"<.*", "", e.key)
            per_call[name] = (per_call.get(name, 0.0)
                              + e.device_time_total / 1e3 / iters)
    bwd = {name: t for name, t in per_call.items() if "flash_fwd" not in name}
    if not bwd or len(bwd) == len(per_call):   # no trace, or no forward seen
        return None, per_call
    return sum(bwd.values()), bwd


def check_training_kernels(fa, label, b, t, h, d, dtype, causal, tol, seed):
    """K2 (o, lse), K4 (dq) and K5 (dk, dv) against their plain versions on
    the same inputs; the backward takes K2's o and lse as residuals.
    Returns (inputs, {kernel: max abs err})."""
    q, k, v = strided_qkv(b, t, h, d, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, causal)
    want_o, want_lse = per_row(
        partial(fa.flash_attention_lse_reference, causal=causal), q, k, v)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta)
    dq = fa.flash_attention_bwd_dq(*args, causal)
    dk, dv = fa.flash_attention_bwd_dkv(*args, causal)
    want_dq = per_row(
        partial(fa.flash_attention_bwd_dq_reference, causal=causal), *args)
    want_dk, want_dv = per_row(
        partial(fa.flash_attention_bwd_dkv_reference, causal=causal), *args)
    torch.cuda.synchronize()
    atol, rtol, row_rtol = tol
    errs = {"fwd_lse": compare(f"K2 o   {label}", o, want_o, atol, rtol,
                               row_rtol)}
    lse_err = (lse - want_lse).abs().max().item()
    # lse: f32 max and sum of the same f32 scores, summed in another order
    lse_ok = bool(torch.isfinite(lse).all()) and lse_err <= LSE_ATOL
    print(f"  K2 lse {label}: max_abs_err {lse_err:.3e} (<= {LSE_ATOL:g}) "
          f"{'ok' if lse_ok else 'FAIL'}")
    if not lse_ok:
        raise SystemExit(f"K2 lse disagrees with its plain version ({label})")
    errs["lse"] = lse_err
    # gradient rows can be ~0 (dS = p(dP - delta) is a difference of two
    # near-equal sums), so the row bound has a floor of atol
    errs["bwd_dq"] = compare(f"K4 dq  {label}", dq, want_dq, atol, rtol,
                             row_rtol, atol)
    errs["bwd_dkv"] = max(
        compare(f"K5 dk  {label}", dk, want_dk, atol, rtol, row_rtol, atol),
        compare(f"K5 dv  {label}", dv, want_dv, atol, rtol, row_rtol, atol))
    return args, errs


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one card", file=sys.stderr)
        return 1
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # f32 results are compared in f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from deeplearning4j_tpu_torch.models.zoo.transformer import TransformerLM
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    print("phase 2: build")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    print("phase 3: kernels against their plain versions on the card")
    H, D = FULL["n_heads"], FULL["d_model"] // FULL["n_heads"]
    q, k, v = strided_qkv(B, T, H, D, torch.bfloat16, seed=1)
    # bf16/fp16, element-wise: one step of the output type (relative 2^-7 /
    # 2^-10) can flip between two roundings of nearly equal f32 sums. Per
    # row: the kernel rounds p = exp(s - running max) to the input type
    # where the plain version rounds exp(s - row max), so each p differs by
    # up to one rounding (2^-8 / 2^-11 relative); with the output's own
    # rounding that keeps a row within ~0.5% / ~0.07% of the plain row.
    # T=1000 and T=1025 leave 24 and 63 padded keys in the last kv tile.
    bf16_tol = dict(atol=1e-2, rtol=1e-2, row_rtol=1e-2)
    fp16_tol = dict(atol=2e-3, rtol=2e-3, row_rtol=2e-3)
    # one 128-key tile of the Hopper kernel first, then the tile edges: one
    # row, a key tile (128) less or more one row, a query tile (192 rows at
    # D=64) and one more, two key tiles and one
    check_flash(fa, "single tile B=1 T=128 H=1 D=64 bf16 full",
                *strided_qkv(1, 128, 1, 64, torch.bfloat16, seed=20),
                False, None, **bf16_tol)
    for t in (1, 127, 129, 193, 257):
        check_flash(fa, f"tile edge B=1 T={t} H=8 D=64 bf16 causal",
                    *strided_qkv(1, t, 8, 64, torch.bfloat16, seed=20 + t),
                    True, None, **bf16_tol)
    err_main = check_flash(fa, f"B={B} T={T} H={H} D={D} bf16 causal",
                           q, k, v, True, None, **bf16_tol)
    check_flash(fa, "B=2 T=1025 H=8 D=64 bf16 full",
                *strided_qkv(2, 1025, 8, 64, torch.bfloat16, seed=6),
                False, None, **bf16_tol)
    check_flash(fa, "B=2 T=1000 H=8 D=64 bf16 full scale=0.05",
                *strided_qkv(2, 1000, 8, 64, torch.bfloat16, seed=2),
                False, 0.05, **bf16_tol)
    check_flash(fa, "B=2 T=1000 H=8 D=128 fp16 causal",
                *strided_qkv(2, 1000, 8, 128, torch.float16, seed=3),
                True, None, **fp16_tol)
    # f32: the kernel's FMA order against cuBLAS's f32 products
    check_flash(fa, "B=2 T=300 H=4 D=64 f32 causal",
                *strided_qkv(2, 300, 4, 64, torch.float32, seed=4),
                True, None, atol=1e-5, rtol=1e-5, row_rtol=1e-5)

    print("phase 4: timing at the main path's shape")
    k1_report = fwd_report(fa, _build, 0)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, True), iters=20)
    plain_ms = cuda_ms(lambda: flash_plain(fa, q, k, v, True), iters=2,
                       warmup=1)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=20)
    flops = 4 * B * H * D * T * (T + 1) / 2       # causal: keys <= row
    nbytes = 4 * B * T * H * D * q.element_size()  # q, k, v read; o written
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"  flash kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, sdpa "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"roofline share {bound_ms / ms:.3f}, "
          f"{flops / ms / 1e9:.1f} TFLOP/s")
    del q, k, v, qt, kt, vt

    print("phase 5: main path at full width (bf16)")
    lm = TransformerLM(**FULL, dtype=torch.bfloat16, device="cuda")
    tokens = torch.randint(0, FULL["vocab_size"], (B, T),
                           generator=torch.Generator().manual_seed(5)).cuda()
    fa.reset_launches()
    t0 = time.perf_counter()
    logits = lm.logits(tokens)
    torch.cuda.synchronize()
    logits_ms = 1e3 * (time.perf_counter() - t0)
    n_logits = fa.launches["fwd"]
    if n_logits != FULL["n_layers"]:
        raise SystemExit(f"logits launched the flash kernel {n_logits} "
                         f"times, not {FULL['n_layers']}")
    if (logits.shape != (B, T, FULL["vocab_size"])
            or logits.dtype != torch.bfloat16
            or not bool(torch.isfinite(logits).all())):
        raise SystemExit(f"bad logits {tuple(logits.shape)} {logits.dtype}")
    del logits
    print(f"  logits [{B}, {T}]: first call {logits_ms:.1f} ms wall, "
          f"{n_logits} flash launches")

    prompt = tokens[0, :1024].tolist()
    requests = [
        ("generate(use_cache=False)", lambda: lm.generate(prompt, 8)),
        ("generate(use_cache=True)",
         lambda: lm.generate(prompt, 8, use_cache=True)),
        ("generate_batch", lambda: lm.generate_batch(tokens[:, :1024], 8)),
    ]
    for name, call in requests:
        before = fa.launches["fwd"]
        t0 = time.perf_counter()
        out = call()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        rows = out if name == "generate_batch" else [out]
        new = [list(map(int, r[1024:])) for r in rows]
        if any(len(n) != 8 or not all(0 <= t < FULL["vocab_size"]
                                      for t in n) for n in new):
            raise SystemExit(f"{name} returned bad tokens {new}")
        added = fa.launches["fwd"] - before
        want = 8 * FULL["n_layers"] if name.endswith("False)") else 0
        if added != want:
            raise SystemExit(f"{name} launched the flash kernel {added} "
                             f"times, not {want}")
        print(f"  {name}: prompt 1024 -> 8 new tokens {new} in "
              f"{wall_ms:.1f} ms wall, {added} flash launches")
    main_launches = fa.launches["fwd"]    # read before the timing below
    if fa.launches != {"fwd": main_launches, "fwd_lse": 0, "partial": 0,
                       "bwd_dq": 0, "bwd_dkv": 0}:
        raise SystemExit(f"serving launched other kernels: {fa.launches}")
    warm_ms = cuda_ms(lambda: lm.logits(tokens), iters=3, warmup=1)
    print(f"  main path: {main_launches} flash launches; warm logits "
          f"[{B}, {T}] {warm_ms:.2f} ms ({B * T / warm_ms:.0f} tokens/ms), "
          f"of which flash {FULL['n_layers']} x {ms:.3f} ms = "
          f"{FULL['n_layers'] * ms / warm_ms:.1%}")
    # the re-encode of generate(use_cache=False): one K1 call at B=1 over
    # the prompt and its new tokens (8 heads x 6 query tiles at T=1024). At
    # this size CUDA events time the host's launches as much as the card,
    # so the device time comes from a trace.
    rq, rk, rv = strided_qkv(1, 1024, H, D, torch.bfloat16, seed=9)
    reencode = {"ms": cuda_ms(lambda: fa.flash_attention(rq, rk, rv, True),
                              iters=50)}
    reencode["device_ms"], = device_ms(
        lambda: fa.flash_attention(rq, rk, rv, True),
        ("flash_fwd_hopper_kernel",))
    print(f"  K1 at the re-encode shape B=1 T=1024 H={H} D={D}: "
          f"{shown_ms(reencode['ms'])} by CUDA events, "
          f"{shown_ms(reencode['device_ms'])} on the card (trace)")
    del lm, rq, rk, rv

    print("phase 6: same weights, f32, card (kernel) vs CPU (plain)")
    small = dict(FULL, n_layers=1, dtype=torch.float32)
    gpu = TransformerLM(**small, device="cuda")
    cpu = TransformerLM(**small, device="cpu")
    for (name, a), (_, b) in zip(gpu.state_dict().items(),
                                 cpu.state_dict().items()):
        if not torch.equal(a.cpu(), b):
            raise SystemExit(f"weights differ between devices: {name}")
    x = tokens[:2, :512]
    err = (gpu.logits(x).cpu() - cpu.logits(x)).abs().max().item()
    # 1e-4: cuBLAS and the CPU sum the width-512 and width-2048 products in
    # another order; logits are O(1)
    print(f"  logits [2, 512] max_abs_err {err:.3e} (tolerance 1e-4)")
    if not err <= 1e-4:
        raise SystemExit("card and CPU logits disagree")
    flash_toks = gpu.generate(prompt[:64], 8, use_cache=False)
    dense_toks = gpu.generate(prompt[:64], 8, use_cache=True)
    print(f"  greedy flash re-encode {flash_toks[64:]} == dense KV cache "
          f"{dense_toks[64:]}: {flash_toks == dense_toks}")
    if flash_toks != dense_toks:
        raise SystemExit("flash and dense greedy tokens differ")

    del gpu, cpu
    train = training_phases(fa, _build, TransformerLM, H, D)
    ring = ring_phases(fa, _build, H, D)
    core, serving = training_core_phases(fa)
    decode = decode_serving_phase(fa)
    recurrent = char_rnn_phase(fa)
    embeddings = embeddings_phase(fa)
    parallel = parallel_phase(fa, core["resnet50_bf16_full"])
    fused = fused_phase(fa)
    spec_kv = spec_kv_phase(fa)
    fleet = fleet_phase(fa)
    tools = tools_phase(fa)
    pretrain = pretrain_phase(fa)
    model_parallel = model_parallel_phase(fa)
    ui = ui_phase(fa)
    graph_stream = graph_stream_phase(fa)

    shape = f"B={B} T={T} H={H} D={D} bf16 causal"
    src = "deeplearning4j_tpu_torch/ops/csrc/"
    ref = "deeplearning4j_tpu/ops/flash_attention.py:"
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": src + "flash_attention_fwd.cu", "replaces": ref + "108",
        "launches": main_launches, "max_abs_err": err_main, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "shape": shape, "kernel": k1_report,
        "reencode": dict(reencode,
                         shape=f"B=1 T=1024 H={H} D={D} bf16 causal")}]
    for name, source, line in (
            ("fwd_lse", "flash_attention_fwd.cu", "122"),
            ("bwd_dq", "flash_attention_bwd.cu", "298"),
            ("bwd_dkv", "flash_attention_bwd.cu", "344")):
        kernels.append(dict({
            "name": f"flash_attention_{name}", "route": "cuda",
            "source": src + source, "replaces": ref + line,
            "launches": train["launches"][name]}, **train["kernels"][name],
            shape=shape, **ring["extra"].get(name, {})))
    kernels.insert(2, dict({
        "name": "flash_attention_partial", "route": "cuda",
        "source": src + "flash_attention_fwd.cu", "replaces": ref + "203"},
        **ring["partial"]))
    # phase 31: the GPipe path's launches per rank (3 fit_batch steps, one
    # forward) and each kernel at the stage shape
    for entry in kernels:
        key = entry["name"][len("flash_attention_"):]
        if key in model_parallel["pipeline_launches"]:
            entry["pipeline_launches"] = \
                model_parallel["pipeline_launches"][key]
            entry["stage_shape"] = model_parallel["stage_shape"][key]
    print(json.dumps({"training_core": core}))
    print(json.dumps({"data_and_serving": serving}))
    print(json.dumps({"decode_serving": decode}))
    print(json.dumps({"recurrent": recurrent}))
    print(json.dumps({"embeddings": embeddings}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"fused": fused}))
    print(json.dumps({"spec_kv": spec_kv}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"tools": tools}))
    print(json.dumps({"pretrain": pretrain}))
    print(json.dumps({"model_parallel": model_parallel}))
    print(json.dumps({"ui": ui}))
    print(json.dumps({"graph_stream": graph_stream}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def training_phases(fa, _build, TransformerLM, H, D):
    """Phases 7-10. Returns {"launches": {kernel: main-path count},
    "kernels": {kernel: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms, ...}}}."""
    print("phase 7: training kernels against their plain versions")
    # bf16/fp16 element-wise and per row as for K1 (one step of the output
    # type may flip; p and ds are rounded from f32 values that the kernel
    # and cuBLAS sum in another order)
    bf16_tol, fp16_tol = (1e-2, 1e-2, 1e-2), (2e-3, 2e-3, 2e-3)
    # single tiles first: one 128-key tile of K2's Hopper kernel; K4's own
    # 128-query tile against one or two 64-key halves of its first kv tile,
    # K5's 128-key tile against one or two 64-query tiles, both masks. Then
    # the tile edges: one row, a tile of 64 and of 128 rows less or more one,
    # three tiles of 64 and one more, four and one more.
    for t in (64, 128):
        for causal in (False, True):
            check_training_kernels(
                fa, f"single tile B=1 T={t} H=1 D=64 bf16 "
                f"{'causal' if causal else 'full'}", 1, t, 1, 64,
                torch.bfloat16, causal, bf16_tol, seed=20 + t + causal)
    for t in (1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 257):
        for causal in (True, False):
            check_training_kernels(
                fa, f"tile edge B=1 T={t} H=8 D=64 bf16 "
                f"{'causal' if causal else 'full'}", 1, t, 8, 64,
                torch.bfloat16, causal, bf16_tol, seed=300 + t + causal)
    args, errs = check_training_kernels(
        fa, f"B={B} T={T} H={H} D={D} bf16 causal", B, T, H, D,
        torch.bfloat16, True, bf16_tol, seed=11)
    # T=1025: 63 padded keys and 63 padded queries in the last tiles
    check_training_kernels(fa, "B=2 T=1025 H=8 D=64 bf16 full", 2, 1025, 8,
                           64, torch.bfloat16, False, bf16_tol, seed=12)
    check_training_kernels(fa, "B=2 T=1000 H=8 D=128 fp16 causal", 2, 1000,
                           8, 128, torch.float16, True, fp16_tol, seed=13)
    check_training_kernels(fa, "B=2 T=300 H=4 D=64 f32 causal", 2, 300, 4,
                           64, torch.float32, True, (1e-5, 1e-5, 1e-5),
                           seed=14)

    print("phase 8: training kernels timed at the training shape")
    reports = {"fwd_lse": fwd_report(fa, _build, 1),
               "bwd_dq": bwd_report(fa, _build, True),
               "bwd_dkv": bwd_report(fa, _build, False)}
    q, k, v, do, lse, delta = args
    calls = {  # kernel wrapper, plain version, inputs
        "fwd_lse": (fa.flash_attention_fwd_lse,
                    fa.flash_attention_lse_reference, (q, k, v)),
        "bwd_dq": (fa.flash_attention_bwd_dq,
                   fa.flash_attention_bwd_dq_reference, args),
        "bwd_dkv": (fa.flash_attention_bwd_dkv,
                    fa.flash_attention_bwd_dkv_reference, args),
    }
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_()
                  for a in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        # with inputs that need grad, flash SDPA also returns the logsumexp
        lib_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=20)
    lib_bwd, lib_bwd_kernels = sdpa_backward_ms(q, k, v, do, True)
    pairs = B * H * T * (T + 1) / 2            # causal (query, key) pairs
    panel = B * T * H * D * q.element_size()   # one [B, T, H, D] tensor
    row_stats = B * H * T * 4                  # one f32 [B, H, T] tensor
    work = {  # (FLOP, bytes: each input read once, each output written once)
        "fwd_lse": (4 * D * pairs, 4 * panel + row_stats),
        "bwd_dq": (6 * D * pairs, 5 * panel + 2 * row_stats),
        "bwd_dkv": (8 * D * pairs, 6 * panel + 2 * row_stats),
    }
    library = {"fwd_lse": lib_fwd, "bwd_dq": lib_bwd, "bwd_dkv": lib_bwd}
    kernels = {}
    for name, (kernel_fn, plain_fn, inputs) in calls.items():
        k_ms = cuda_ms(lambda: kernel_fn(*inputs, True), iters=10)
        p_ms = cuda_ms(lambda: per_row(partial(plain_fn, causal=True),
                                       *inputs), iters=2, warmup=1)
        b_ms, b_by = bound(*work[name])
        kernels[name] = {"max_abs_err": errs[name], "ms": k_ms,
                         "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": library[name], "kernel": reports[name]}
        print(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
              f"library {shown_ms(library[name])}, bound {b_ms:.4f} ms "
              f"({b_by}), roofline share {b_ms / k_ms:.3f}, "
              f"{work[name][0] / k_ms / 1e9:.1f} TFLOP/s")
    kernels["fwd_lse"]["lse_max_abs_err"] = errs["lse"]
    for name in ("bwd_dq", "bwd_dkv"):
        kernels[name]["library_call"] = (
            "SDPA flash backward alone, dq/dk/dv together (device time, "
            "torch.profiler)")
    print(f"  SDPA flash: forward {lib_fwd:.4f} ms (CUDA events); backward "
          f"{shown_ms(lib_bwd)} on the card (trace: "
          f"{json.dumps(lib_bwd_kernels)})")
    del args, q, k, v, do, lse, delta, qt, kt, vt

    print(f"phase 9: training main path at full width (bf16, "
          f"{TRAIN_STEPS} fit_batch steps)")
    lm = TransformerLM(**FULL, dtype=torch.bfloat16, learning_rate=0.1,
                       momentum=0.9, device="cuda")
    x = torch.randint(0, FULL["vocab_size"], (B, T),
                      generator=torch.Generator().manual_seed(7)).cuda()
    y = (x + 1) % FULL["vocab_size"]
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(lm.fit_batch(x, y))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    launches = dict(fa.launches)
    n = FULL["n_layers"] * TRAIN_STEPS
    if launches != {"fwd": 0, "fwd_lse": n, "partial": 0, "bwd_dq": n,
                    "bwd_dkv": n}:
        raise SystemExit(f"fit_batch launches {launches}: want {n} each of "
                         f"K2, K4, K5 and no K1 or K3")
    warm_ms = sum(step_ms[1:]) / (TRAIN_STEPS - 1)
    print(f"  losses {losses}")
    print(f"  step ms (CUDA events) {[round(t, 2) for t in step_ms]}; warm "
          f"mean {warm_ms:.2f} ms, {B * T / warm_ms * 1e3:.0f} tokens/s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches}")
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise SystemExit(f"training losses not finite and falling: {losses}")
    del lm

    print("phase 10: same weights, f32, three steps: card (kernels) vs CPU "
          "(plain)")
    small = dict(FULL, n_layers=1, dtype=torch.float32)
    gpu = TransformerLM(**small, device="cuda")
    cpu = TransformerLM(**small, device="cpu")
    xs, ys = x[:2, :512], y[:2, :512]
    got = [gpu.fit_batch(xs, ys) for _ in range(3)]
    want = [cpu.fit_batch(xs.cpu(), ys.cpu()) for _ in range(3)]
    loss_err = max(abs(a - b) for a, b in zip(got, want))
    param_err = max((a.detach().cpu() - b.detach()).abs().max().item()
                    for a, b in zip(gpu.parameters(), cpu.parameters()))
    # 1e-5: cuBLAS and the CPU sum the 512- and 2048-wide products in
    # another order, and each update carries the difference on (read on an
    # H100: 4.8e-7, one f32 step of the loss, and 1.2e-7)
    print(f"  losses card {got} cpu {want}: max abs diff {loss_err:.3e}; "
          f"parameters max abs diff {param_err:.3e} (tolerance 1e-5 each)")
    if not (loss_err <= 1e-5 and param_err <= 1e-5):
        raise SystemExit("card and CPU training disagree")
    return {"launches": launches, "kernels": kernels}


def check_partial(fa, label, q, k, v, q_off, k_off, causal, tol):
    """K3 (acc, m, l) against its plain version. acc is held after dividing
    both by the plain l, which puts it on the output's scale, where K1's
    bounds (phase 3) apply; a row that sees no key of the hop (l = 0) must
    have exactly acc 0, m -1e30, l 0. Returns (max abs err of acc / l,
    (acc, m, l))."""
    got = fa.flash_attention_partial(q, k, v, q_off, k_off, causal)
    want = per_row(partial(fa.flash_attention_partial_reference, q_off=q_off,
                           k_off=k_off, causal=causal), q, k, v)
    torch.cuda.synchronize()
    (acc, m, l), (w_acc, w_m, w_l) = got, want
    norm = w_l.clamp_min(1e-30).transpose(1, 2)[..., None]
    err = compare(f"K3 acc/l {label}", acc / norm, w_acc / norm, *tol)
    # m: the max of the same f32 scores, summed in another order (K2's lse
    # reads 1.9e-6 at T=8192). l: f32 sums of up to T p's in another order,
    # each p carrying expf's error and one rescale per kv tile.
    m_err = (m - w_m).abs().max().item()
    l_rel = ((l - w_l).abs() / w_l.clamp_min(1e-30)).max().item()
    unseen = w_l == 0
    exact = bool((m[unseen] == fa.FINITE_NEG).all() and (l[unseen] == 0).all()
                 and not acc.transpose(1, 2)[unseen].any())
    ok = (m_err <= 1e-5 and l_rel <= 1e-4 and exact
          and bool(torch.isfinite(m).all() and torch.isfinite(l).all()))
    print(f"  K3 m, l {label}: m max_abs_err {m_err:.3e} (<= 1e-5), l max "
          f"rel err {l_rel:.3e} (<= 1e-4), {int(unseen.sum())} rows that see "
          f"no key exactly (0, -1e30, 0): {exact} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"K3 m/l disagree with the plain version ({label})")
    return err, want


def check_hop_backward(fa, label, q, k, v, q_off, k_off, causal, tol, seed,
                       fwd):
    """K4 (dq) and K5 (dk, dv) with the hop's offsets and f32 outputs against
    their plain versions. lse and delta come from the plain partial `fwd`
    of the same hop, so every row with a visible key has its exact softmax.
    Returns ((q, k, v, delta, do, lse), {kernel: max abs err})."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    acc, m, l = fwd
    lc = l.clamp_min(1e-30)
    lse = m + torch.log(lc)
    delta = fa.attention_delta((acc / lc.transpose(1, 2)[..., None]).to(
        q.dtype), do)
    dq, dk, dv = fa.flash_attention_bwd_partial(q, k, v, delta, do, lse,
                                                q_off, k_off, causal)
    kw = dict(causal=causal, q_off=q_off, k_off=k_off,
              out_dtype=torch.float32)
    args = (q, k, v, do, lse, delta)
    want_dq = per_row(partial(fa.flash_attention_bwd_dq_reference, **kw),
                      *args)
    want_dk, want_dv = per_row(
        partial(fa.flash_attention_bwd_dkv_reference, **kw), *args)
    torch.cuda.synchronize()
    if causal and k_off >= q_off + q.shape[1] and (
            dq.any() or dk.any() or dv.any()):
        raise SystemExit(f"K4/K5 wrote a gradient for a wholly masked hop "
                         f"({label})")
    errs = {"bwd_dq": compare(f"K4 dq f32  {label}", dq, want_dq, *tol,
                              tol[0])}
    errs["bwd_dkv"] = max(
        compare(f"K5 dk f32  {label}", dk, want_dk, *tol, tol[0]),
        compare(f"K5 dv f32  {label}", dv, want_dv, *tol, tol[0]))
    return (q, k, v, delta, do, lse), errs


def ring_qkv(b, t, h, d, dtype, seed, device="cuda"):
    """The ring's global q, k, v, [B, T, H, D] contiguous, from a seed; the
    same on every process that asks."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(3, b, t, h, d, generator=gen, device=device)
    return [a.to(dtype).contiguous() for a in qkv]


def ring_rank(rank, world, store, out_dir, backend, seed):
    """One rank of the ring main path (phase 14), started by spawn: join the
    group, run (a) and (b) on this rank's chunk with the counters set to 0
    before each and read after, time both warm, run the f32 case on the card
    and on the CPU, and save what the parent checks."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import ring_attention as ra
    ring_self_attention = ra.ring_self_attention
    device = rank if backend == "nccl" else 0
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=RING_GROUP_TIMEOUT_S))
    barrier = (partial(dist.barrier, device_ids=[device])
               if backend == "nccl" else dist.barrier)
    # the f32 case's CPU ring needs a group that carries CPU tensors
    cpu_group = dist.new_group(backend="gloo") if backend == "nccl" else None
    tq = T // world
    mine = slice(rank * tq, (rank + 1) * tq)
    q, k, v = (a[:, mine].contiguous() for a in ring_qkv(
        B, T, FULL["n_heads"], FULL["d_model"] // FULL["n_heads"],
        torch.bfloat16, seed))
    ring = partial(ring_self_attention, causal=True, use_flash=True)
    n_total = q.numel() * world

    def inference():
        with torch.no_grad():
            return ring(q, k, v)

    def training():
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        out = ring(*leaves)
        loss = (out.float() ** 2).sum() / n_total    # mean over the global o
        return out.detach(), torch.autograd.grad(loss, leaves)

    res = {}
    fa.reset_launches()
    res["out"] = inference()
    torch.cuda.synchronize()
    res["launches_inference"] = dict(fa.launches)
    fa.reset_launches()
    res["out_train"], res["grads"] = training()
    torch.cuda.synchronize()
    res["launches_training"] = dict(fa.launches)
    barrier()
    res["fwd_ms"] = cuda_ms(inference, iters=5, warmup=1)
    barrier()
    res["fwd_bwd_ms"] = cuda_ms(training, iters=3, warmup=1)
    # one rotation as the forward moves it (k, v) and as the backward does
    # (k, v and the f32 dk, dv accumulators)
    acc32 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for key, payload in (("rotate_fwd_ms", (k, v)),
                         ("rotate_bwd_ms", (k, v, acc32, acc32))):
        barrier()
        res[key] = cuda_ms(lambda: ra._ppermute(payload, None), iters=5,
                           warmup=1)

    # f32, T=1024: the kernels on the card against the plain versions on the
    # CPU, through the same ring; loss sum(o**2)/2, so dO = o
    f32 = [a[:, rank * 256:(rank + 1) * 256].contiguous() for a in ring_qkv(
        2, 1024, 4, 64, torch.float32, seed + 1, "cpu")]
    f32_res = []
    for dev, group in (("cuda", None), ("cpu", cpu_group)):
        leaves = [a.to(dev).requires_grad_() for a in f32]
        out = ring(*leaves, group=group)
        grads = torch.autograd.grad((out ** 2).sum() / 2, leaves)
        f32_res.append([t.detach().cpu() for t in (out, *grads)])
    res["f32_err"] = max((a - b).abs().max().item()
                         for a, b in zip(*f32_res))
    res["f32_finite"] = all(bool(torch.isfinite(a).all())
                            for a in f32_res[0])
    # the sequence-parallel SelfAttentionLayer (the einsum ring, f32): this
    # rank's chunk of its output
    params, x, mask = attention_layer_inputs(seed + 2)
    part = slice(rank * ATT_T // world, (rank + 1) * ATT_T // world)
    with torch.no_grad():
        res["layer_out"] = attention_layer().with_sequence_parallel(
            None).forward(params, x[:, part].contiguous(),
                          mask=mask[:, part].contiguous())
    to_cpu = lambda x: x.cpu() if torch.is_tensor(x) else x
    res = {key: ([to_cpu(t) for t in val] if isinstance(val, tuple)
                 else to_cpu(val)) for key, val in res.items()}
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def attention_layer():
    from deeplearning4j_tpu_torch.nn.conf.layers import SelfAttentionLayer
    return SelfAttentionLayer(n_in=FULL["d_model"], n_out=FULL["d_model"],
                              n_heads=FULL["n_heads"], causal=True)


def attention_layer_inputs(seed):
    """(params, x [2, ATT_T, d_model], mask [2, ATT_T]) of phase 14's
    SelfAttentionLayer, f32 on cuda:0, from a seed: the same on every
    process that asks. Every row is padded at its end (key 0 stays valid,
    so every causal query sees a key)."""
    d = FULL["d_model"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = {k: torch.randn(d, d, generator=gen, device="cuda") / d ** 0.5
              for k in ("Wq", "Wk", "Wv", "Wo")}
    params["b"] = torch.randn(d, generator=gen, device="cuda") / d ** 0.5
    x = torch.randn(2, ATT_T, d, generator=gen, device="cuda")
    mask = torch.ones(2, ATT_T, device="cuda")
    mask[0, ATT_T - 100:] = 0.0
    mask[1, ATT_T - 300:] = 0.0
    return params, x, mask


def run_ring(world, backend, seed):
    """Spawn `world` ranks of `ring_rank`, wait at most
    RING_JOIN_TIMEOUT_S, kill what is left and fail unless every rank exits
    0. Returns each rank's saved results."""
    import torch.multiprocessing as mp
    work = Path(__file__).resolve().parent / "build" / f"ring_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=ring_rank, args=(
        r, world, str(work / "store"), str(work), backend, seed))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RING_JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise SystemExit(f"ring ranks over {backend} exited {codes}")
    results = [torch.load(work / f"rank{r}.pt") for r in range(world)]
    shutil.rmtree(work, ignore_errors=True)
    return results


def check_ring(ranks, backend, want_o, label):
    """The ring's counts, its f32 case and its gathered output against the
    single-card flash attention `want_o`. Returns the timings of the slowest
    rank and the gathered gradients (dq, dk, dv)."""
    n = len(ranks)
    inference = {"fwd": 0, "fwd_lse": 0, "partial": n, "bwd_dq": 0,
                 "bwd_dkv": 0}
    training = dict(inference, bwd_dq=n, bwd_dkv=n)
    for r, res in enumerate(ranks):
        if (res["launches_inference"] != inference
                or res["launches_training"] != training):
            raise SystemExit(
                f"ring rank {r} ({backend}) launched "
                f"{res['launches_inference']} without grad and "
                f"{res['launches_training']} with grad: want {inference} "
                f"and {training}")
        # f32: the kernels' FMA order against the CPU's products
        if not (res["f32_finite"] and res["f32_err"] <= 1e-5):
            raise SystemExit(f"f32 ring on the card disagrees with the CPU "
                             f"ring on rank {r}: {res['f32_err']:.3e}")
    print(f"  {label}: launches per rank {inference} without grad, "
          f"{training} with grad; f32 T=1024 ring card vs CPU max abs err "
          f"{max(r['f32_err'] for r in ranks):.3e} (<= 1e-5)")
    gather = lambda get: torch.cat([get(r).cuda() for r in ranks], 1)
    out = gather(lambda r: r["out"])
    if not torch.equal(out, gather(lambda r: r["out_train"])):
        raise SystemExit("the ring's outputs with and without grad differ")
    # bf16 as in phases 3 and 7: a step of bf16 may flip between two
    # roundings of nearly equal f32 sums, and the ring rounds p against each
    # hop's max where the single-card kernel rounds it against its running
    # max
    compare(f"{label} o  vs single card", out, want_o, 1e-2, 1e-2, 1e-2)
    slowest = {key: max(r[key] for r in ranks) for key in (
        "fwd_ms", "fwd_bwd_ms", "rotate_fwd_ms", "rotate_bwd_ms")}
    print(f"  {label}: warm ring forward {slowest['fwd_ms']:.2f} ms, "
          f"forward+backward {slowest['fwd_bwd_ms']:.2f} ms; one rotation "
          f"of (k, v) {slowest['rotate_fwd_ms']:.2f} ms, of (k, v, dk, dv) "
          f"{slowest['rotate_bwd_ms']:.2f} ms (CUDA events, slowest rank)")
    grads = tuple(gather(lambda r: r["grads"][i]) for i in range(3))
    return slowest, grads


def coarse(x, bits):
    """x rounded to the nearest value with `bits` significant bits (bf16 has
    8), ties to even."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * 2 ** bits), e - bits)


def plain_gradients(fa, q, k, v, o, lse):
    """dq, dk, dv of mean(o**2) through the plain backward in f32, for f32
    q, k, v, their f32 lse and an output o, which may be rounded."""
    do = 2 * o / o.numel()
    args = (q, k, v, do, lse, fa.attention_delta(o, do))
    dq = per_row(partial(fa.flash_attention_bwd_dq_reference, causal=True),
                 *args)
    dk, dv = per_row(partial(fa.flash_attention_bwd_dkv_reference,
                             causal=True), *args)
    return dq, dk, dv


def check_gradients(fa, leaves, paths):
    """Holds each bf16 path's gradients of mean(o**2), `paths` = {name: (dq,
    dk, dv)}, against the f32 gradient (the plain forward and backward in
    f32 on the same bf16 inputs), divided by that gradient's rms, within
    GRAD_LIMITS. The controls are the f32 gradient from o rounded to 8
    significant bits (bf16's o: what that rounding alone moves) and to 7:
    the limits must reject the 7-bit one, or they would not tell a path one
    bit coarser than bf16."""
    qf, kf, vf = (a.detach().float() for a in leaves)
    o_ex, lse_ex = per_row(partial(fa.flash_attention_lse_reference,
                                   causal=True), qf, kf, vf)
    exact = plain_gradients(fa, qf, kf, vf, o_ex, lse_ex)
    controls = {f"control, o to {bits} bits": plain_gradients(
        fa, qf, kf, vf, coarse(o_ex, bits), lse_ex) for bits in (8, 7)}
    failed = []
    for name, grads in {**paths, **controls}.items():
        for i, g in enumerate(("dq", "dk", "dv")):
            rms = exact[i].pow(2).mean().sqrt()
            got, want = grads[i].float() / rms, exact[i] / rms
            atol = ((got - want).abs() - 1e-2 * want.abs()).max().item()
            row = ((got - want).norm(dim=-1) / (want.norm(dim=-1) + 1)
                   ).max().item()
            atol_max, row_max = GRAD_LIMITS[g]
            ok = (bool(torch.isfinite(got).all()) and atol <= atol_max
                  and row <= row_max)
            print(f"  {name} {g}/rms vs f32: least atol at rtol 1e-2 "
                  f"{atol:.4e} (<= {atol_max:g}), max row err {row:.4e} "
                  f"(<= {row_max:g}) {'ok' if ok else 'over'}")
            if ok == name.startswith("control, o to 7"):
                failed.append(f"{name} {g}")
    if failed:
        raise SystemExit(f"gradients vs the f32 gradient: {failed} broke "
                         f"the rule (paths within {GRAD_LIMITS}, the 7-bit "
                         f"control over them)")


def ring_main_path(fa, H, D, backend):
    """Phase 14 over one backend: the ranks (gloo: all on cuda:0; NCCL: one
    per card), the single-card flash attention (K2, K4, K5) on the same
    global input on cuda:0 as the output's reference, both paths' gradients
    against the f32 gradient, the checks. Returns the slowest rank's
    timings and the launches summed over the ranks."""
    seed = 51
    ranks = run_ring(RING, backend, seed)
    leaves = [a.requires_grad_() for a in ring_qkv(B, T, H, D,
                                                   torch.bfloat16, seed)]
    o = fa.flash_attention(*leaves, True)
    single = torch.autograd.grad((o.float() ** 2).mean(), leaves)
    label = (f"{RING} ranks sharing one card over gloo" if backend == "gloo"
             else f"{RING} ranks, one per card, over NCCL")
    result, ring_grads = check_ring(ranks, backend, o.detach(), label)
    del o
    # the layer: each rank's chunk against the local layer's slice, f32
    # (1e-5: the ring folds the hops' softmax in another order)
    params, x, mask = attention_layer_inputs(seed + 2)
    with torch.no_grad():
        want = attention_layer().forward(params, x, mask=mask)
    tl = ATT_T // len(ranks)
    result["layer_err"] = max(
        (r["layer_out"].cuda() - want[:, i * tl:(i + 1) * tl]).abs().max()
        .item() for i, r in enumerate(ranks))
    _check(f"{label}: sequence-parallel SelfAttentionLayer (d_model "
           f"{FULL['d_model']}, causal, masked, f32, B=2 T={ATT_T}) vs the "
           f"local layer, max abs err", result["layer_err"], 1e-5)
    del params, x, mask, want
    check_gradients(fa, leaves, {
        "ring": ring_grads, "single card (K2, K4, K5)": single})
    result["launches"] = {
        name: sum(r["launches_inference"][name]
                  + r["launches_training"][name] for r in ranks)
        for name in ("partial", "bwd_dq", "bwd_dkv")}
    print("ring: " + json.dumps({
        "ranks": RING, "backend": backend,
        "cards": 1 if backend == "gloo" else RING,
        **{key: result[key] for key in ("fwd_ms", "fwd_bwd_ms",
                                        "rotate_fwd_ms", "rotate_bwd_ms",
                                        "layer_err")},
        "note": ("four ranks share one card and rotate K/V through the "
                 "host; not a multi-card figure") if backend == "gloo"
        else "one rank per card; NCCL P2P over NVLink"}))
    return result


def ring_phases(fa, _build, H, D):
    """Phases 11-14. Returns {"partial": K3's kernels-line fields, "extra":
    {kernel: K4/K5 hop fields}}."""
    print(f"phase 11: ring partial (K3) against its plain version, hop of "
          f"T={T} over a ring of {RING}")
    k3_reports = {f"D={d}": fwd_report(fa, _build, 2, d) for d in (64, 128)}
    bf16_tol, fp16_tol, f32_tol = (1e-2, 1e-2, 1e-2), (2e-3, 2e-3, 2e-3), (
        1e-5, 1e-5, 1e-5)
    # one head of 64 rows (one consumer warpgroup's rows against half a
    # 128-key tile) and of 128 rows (one whole kv tile) first; then the
    # Hopper kernel's tile edges (one row; 64, 128, 192 rows less, at and
    # past; two and three kv tiles and one), with the causal edge on a tile
    # edge and inside a tile (keys 37 rows later or earlier; a kv chunk whose
    # first key only the last row sees) and a non-causal hop at (100, 0)
    for t in (64, 128):
        for causal in (False, True):
            check_partial(fa, f"single tile B=1 T={t} H=1 D=64 bf16 (0, 0) "
                          f"{'causal' if causal else 'full'}",
                          *strided_qkv(1, t, 1, 64, torch.bfloat16,
                                       seed=60 + t), 0, 0, causal, bf16_tol)
    for t in (1, 63, 64, 127, 128, 129, 191, 192, 193, 257, 385):
        eq, ek, ev = strided_qkv(1, t, 8, 64, torch.bfloat16, seed=400 + t)
        for q_off, k_off, causal in ((0, 0, True), (t, 0, True), (0, t, True),
                                     (0, 37, True), (37, 0, True),
                                     (0, t - 1, True), (100, 0, False)):
            check_partial(fa, f"tile edge B=1 T={t} H=8 D=64 bf16 ({q_off}, "
                          f"{k_off}) {'causal' if causal else 'full'}", eq,
                          ek, ev, q_off, k_off, causal, bf16_tol)
    q, k, v = ring_qkv(B, HOP_T, H, D, torch.bfloat16, seed=21)
    hops = [("diagonal", HOP_T, HOP_T, True), ("visible", 2 * HOP_T, 0, True),
            ("wholly masked", 0, HOP_T, True),
            ("non-causal", 0, HOP_T, False)]
    shape = f"B={B} Tq=Tk={HOP_T} H={H} D={D} bf16"
    fwds, k3_err = {}, 0.0
    for label, q_off, k_off, causal in hops:
        err, fwds[label] = check_partial(
            fa, f"{shape} {label} ({q_off}, {k_off})", q, k, v, q_off, k_off,
            causal, bf16_tol)
        k3_err = max(k3_err, err)
    # T=1025: 63 padded keys and queries in the last tiles; part overlaps
    # leave rows that see no key of the hop inside computed tiles
    edges = [("B=2 T=1025 H=8 D=64 bf16 visible", (2, 1025, 8, 64,
                                                   torch.bfloat16),
              1025, 0, True, bf16_tol),
             ("B=2 T=1025 H=8 D=64 bf16 diagonal", (2, 1025, 8, 64,
                                                    torch.bfloat16),
              0, 0, True, bf16_tol),
             ("B=2 T=1000 H=8 D=128 fp16 part overlap", (2, 1000, 8, 128,
                                                         torch.float16),
              0, 500, True, fp16_tol),
             ("B=2 T=300 H=4 D=64 f32 part overlap", (2, 300, 4, 64,
                                                      torch.float32),
              150, 300, True, f32_tol)]
    edge_inputs = {}
    for i, (label, shp, q_off, k_off, causal, tol) in enumerate(edges):
        eq, ek, ev = strided_qkv(*shp, seed=22 + i)
        _, fwd = check_partial(fa, f"{label} ({q_off}, {k_off})", eq, ek, ev,
                               q_off, k_off, causal, tol)
        edge_inputs[label] = (eq, ek, ev, fwd)

    print("phase 12: K4 and K5 with hop offsets and f32 outputs against "
          "their plain versions")
    hop_errs = {"bwd_dq": 0.0, "bwd_dkv": 0.0}
    for i, (label, q_off, k_off, causal) in enumerate(hops):
        args, errs = check_hop_backward(
            fa, f"{shape} {label}", q, k, v, q_off, k_off, causal, bf16_tol,
            31 + i, fwds[label])
        hop_errs = {n: max(hop_errs[n], errs[n]) for n in hop_errs}
        if label == "visible":
            visible = args
    for i, (label, _, q_off, k_off, causal, tol) in enumerate(edges):
        eq, ek, ev, fwd = edge_inputs[label]
        check_hop_backward(fa, label, eq, ek, ev, q_off, k_off, causal, tol,
                           41 + i, fwd)
    del edge_inputs, fwds

    print(f"phase 13: K3, K4, K5 timed on the visible hop ({shape}, "
          f"q_off {2 * HOP_T}, k_off 0)")
    q, k, v, delta, do, lse = visible
    off = dict(q_off=2 * HOP_T, k_off=0)
    f32_out = dict(off, out_dtype=torch.float32)
    bwd_args = (q, k, v, do, lse, delta)
    calls = {  # kernel wrapper, plain version, inputs
        "partial": (partial(fa.flash_attention_partial, causal=True, **off),
                    partial(fa.flash_attention_partial_reference,
                            causal=True, **off), (q, k, v)),
        "bwd_dq": (partial(fa.flash_attention_bwd_dq, causal=True,
                           **f32_out),
                   partial(fa.flash_attention_bwd_dq_reference, causal=True,
                           **f32_out), bwd_args),
        "bwd_dkv": (partial(fa.flash_attention_bwd_dkv, causal=True,
                            **f32_out),
                    partial(fa.flash_attention_bwd_dkv_reference,
                            causal=True, **f32_out), bwd_args),
    }
    pairs = B * H * HOP_T * HOP_T              # every pair of the hop visible
    panel = B * HOP_T * H * D * q.element_size()
    panel32 = B * HOP_T * H * D * 4
    row_stats = B * H * HOP_T * 4
    work = {  # (FLOP, bytes: each input read once, each output written once)
        "partial": (4 * D * pairs, 3 * panel + panel32 + 2 * row_stats),
        "bwd_dq": (6 * D * pairs, 4 * panel + 2 * row_stats + panel32),
        "bwd_dkv": (8 * D * pairs, 4 * panel + 2 * row_stats + 2 * panel32),
    }
    lib_bwd, lib_bwd_kernels = sdpa_backward_ms(q, k, v, do, False)
    # K3's yardstick: flash SDPA's forward returns (o, logsumexp, ...), the
    # same information as K3's (acc, m, l) in normalised form; non-causal on
    # the visible hop, causal on the diagonal one
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    flash_sdpa = torch.ops.aten._scaled_dot_product_flash_attention
    lib_partial = {causal: cuda_ms(lambda: flash_sdpa(qt, kt, vt, 0.0, causal),
                                   iters=20) for causal in (False, True)}
    _, m, l = fa.flash_attention_partial(q, k, v, causal=True, **off)
    lse_diff = (flash_sdpa(qt, kt, vt, 0.0, False)[1] - (m + torch.log(l))
                ).abs().max().item()
    print(f"  the yardstick computes K3's function: SDPA's logsumexp vs K3's "
          f"m + log l on the visible hop, max abs diff {lse_diff:.3e}")
    del qt, kt, vt, m, l
    library = {"partial": lib_partial[False], "bwd_dq": lib_bwd,
               "bwd_dkv": lib_bwd}
    timed = {}
    for name, (kernel_fn, plain_fn, inputs) in calls.items():
        k_ms = cuda_ms(lambda: kernel_fn(*inputs), iters=20)
        p_ms = cuda_ms(lambda: per_row(plain_fn, *inputs), iters=2,
                       warmup=1)
        b_ms, b_by = bound(*work[name])
        timed[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": library[name]}
        print(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
              f"library {shown_ms(library[name])}, bound {b_ms:.4f} ms "
              f"({b_by}), roofline share {b_ms / k_ms:.3f}, "
              f"{work[name][0] / k_ms / 1e9:.1f} TFLOP/s")
    # K3 on the diagonal hop (q_off = k_off): half the pairs, the same bytes.
    # Near 0.08 ms a K3 call is about as long as its wrapper takes on the
    # host, so CUDA events may time the host: the trace gives the card's
    # time, on both hops.
    diagonal = partial(fa.flash_attention_partial, q, k, v, HOP_T, HOP_T,
                       True)
    diag_ms = cuda_ms(diagonal, iters=20)
    diag_flops = 4 * D * B * H * HOP_T * (HOP_T + 1) / 2
    diag_bound, diag_by = bound(diag_flops, work["partial"][1])
    trace = {hop: device_ms(fn, ("flash_fwd_hopper_kernel",))[0] for hop, fn in
             (("visible", partial(calls["partial"][0], q, k, v)),
              ("diagonal", diagonal))}
    timed["partial"]["device_ms"] = trace["visible"]
    timed["partial"]["diagonal"] = {
        "ms": diag_ms, "device_ms": trace["diagonal"],
        "library_ms": lib_partial[True], "bound_ms": diag_bound,
        "bound_by": diag_by,
        "shape": f"{shape}, diagonal hop (q_off = k_off = {HOP_T})"}
    timed["partial"]["library_call"] = (
        "aten._scaled_dot_product_flash_attention on [B, H, T, D] (o and "
        "logsumexp), non-causal; causal on the diagonal hop")
    print(f"  partial, diagonal hop: kernel {diag_ms:.4f} ms, library "
          f"{lib_partial[True]:.4f} ms, bound {diag_bound:.4f} ms "
          f"({diag_by}), roofline share {diag_bound / diag_ms:.3f}, "
          f"{diag_flops / diag_ms / 1e9:.1f} TFLOP/s")
    print(f"  partial on the card (trace): visible hop "
          f"{shown_ms(trace['visible'])}, diagonal hop "
          f"{shown_ms(trace['diagonal'])}")
    print(f"  SDPA flash backward alone, non-causal, [{B}, {H}, {HOP_T}, {D}] "
          f"bf16 (the same dq, dk, dv rounded to bf16): {shown_ms(lib_bwd)} "
          f"on the card (trace: {json.dumps(lib_bwd_kernels)})")
    del visible, q, k, v, delta, do, lse, bwd_args, calls

    print(f"phase 14: ring main path at full width: {RING} ranks on cuda:0 "
          f"over gloo, global B={B} T={T} H={H} D={D} bf16 causal")
    torch.cuda.empty_cache()
    gloo = ring_main_path(fa, H, D, "gloo")
    if torch.cuda.device_count() >= RING:
        ring_main_path(fa, H, D, "nccl")
    else:
        print(f"  NCCL ring skipped: it needs {RING} cards, one per rank "
              f"(NCCL refuses two ranks on one device); this machine has "
              f"{torch.cuda.device_count()}")
    ring_launches = gloo["launches"]
    hop_shape = f"{shape}, visible hop (q_off {2 * HOP_T}, k_off 0)"
    return {
        "partial": dict(timed["partial"], launches=ring_launches["partial"],
                        max_abs_err=k3_err, shape=hop_shape,
                        err_on="acc / plain l", kernel=k3_reports,
                        launches_per_rank={"inference": RING,
                                           "training": RING}),
        "extra": {name: {"ring_launches": ring_launches[name], "hop": dict(
            timed[name], max_abs_err=hop_errs[name], shape=hop_shape,
            out_dtype="float32",
            library_call="SDPA flash backward alone, non-causal, dq/dk/dv "
                         "together, rounded to bf16 (device time, "
                         "torch.profiler)")}
            for name in ("bwd_dq", "bwd_dkv")},
    }


def _one_hot(rng, n, classes):
    import numpy as np
    return np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]


def _max_err(a, b):
    import numpy as np
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _check(label, err, limit):
    print(f"  {label}: {err:.3e} (limit {limit:.3e})")
    if not err <= limit:
        raise SystemExit(f"{label}: {err} over {limit}")


class _DeviceAudit:
    """Every op dispatched while active, with any tensor argument or
    result that is not on the card (a TorchDispatchMode)."""

    def __new__(cls):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten

        class Audit(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.ops, self.off_card = 0, set()

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                self.ops += 1
                for t in tree_flatten((args, kwargs, out))[0]:
                    if isinstance(t, torch.Tensor) and t.device.type != "cuda":
                        self.off_card.add(f"{func} on {t.device}")
                return out

        return Audit()


def lenet_card_vs_cpu():
    """Phase 15. Returns its readings."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    print("phase 15: LeNet (MultiLayerNetwork) f32, batch 64: card vs CPU, "
          "3 Nesterov steps")
    rng = np.random.default_rng(15)
    x = rng.random((64, 784), dtype=np.float32)
    y = _one_hot(rng, 64, 10)
    gpu, cpu = (lenet(device=d, data_type="float32") for d in ("cuda", "cpu"))
    if not np.array_equal(gpu.params(), cpu.params()):
        raise SystemExit("LeNet weights differ between devices")
    # 1e-5: cuDNN and the CPU sum the 5x5 windows and the 800- and
    # 500-wide products in other orders; outputs are probabilities
    out = {"output": _max_err(gpu.output(x), cpu.output(x))}
    _check("output [64, 10] max_abs_err", out["output"], 1e-5)
    losses = [[], []]
    for _ in range(3):
        for net, seen in zip((gpu, cpu), losses):
            net.fit(x, y)
            seen.append(net.score())
    out["losses"] = losses[0]
    out["loss_err"] = _max_err(*losses)
    out["param_err"] = _max_err(gpu.params(), cpu.params())
    print(f"  card losses {losses[0]}")
    _check("losses max_abs_err", out["loss_err"], 1e-5)
    _check("parameters after 3 steps max_abs_err", out["param_err"], 1e-5)
    if not losses[0][-1] < losses[0][0]:
        raise SystemExit("LeNet losses do not fall")
    return out


def resnet_f32_card_vs_cpu():
    """Phase 16. Returns its readings."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
    from deeplearning4j_tpu_torch.models.zoo.resnet import resnet50
    print("phase 16: ResNet-50 (ComputationGraph) f32, full depth, 64x64x3, "
          "batch 2, 10 classes: card vs CPU (and CPU float64)")
    kw = dict(height=64, width=64, num_classes=10)
    gpu = resnet50(device="cuda", data_type="float32", **kw)
    cpu = resnet50(device="cpu", data_type="float32", **kw)
    f64 = resnet50(device="cpu", data_type="float64", **kw)
    f64.set_params(cpu.params())
    if not np.array_equal(gpu.params(), cpu.params()):
        raise SystemExit("ResNet-50 weights differ between devices")
    rng = np.random.default_rng(16)
    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    y = _one_hot(rng, 2, 10)
    outs = [net.output(x)[0] for net in (gpu, cpu, f64)]
    if outs[0].shape != (2, 10) or not np.isfinite(outs[0]).all():
        raise SystemExit(f"bad ResNet-50 output {outs[0].shape}")
    first = [net.score(DataSet(x, y), training=True) for net in (gpu, cpu,
                                                                 f64)]
    out = {"output": _max_err(*outs[:2]), "first_loss": abs(first[0] - first[1]),
           "output_f32_vs_f64": _max_err(*outs[1:]),
           "first_loss_f32_vs_f64": abs(first[1] - first[2])}
    # controls: the same output and training loss through cuDNN with TF32
    # on (the port's forward and loss called outside its own
    # `card_numerics` scope)
    with torch.no_grad():
        acts, *_ = gpu._apply_graph(gpu._cast_params(), gpu._states(),
                                    gpu._inputs([x]), train=False, rng=None)
        tf32_out = acts["fc"].cpu().numpy()
        tf32 = float(gpu._loss(*gpu._batch(MultiDataSet([x], [y])), True,
                               None)[0])
    out["output_tf32"] = _max_err(tf32_out, outs[1])
    out["first_loss_tf32"] = abs(tf32 - first[1])
    print(f"  CPU f32 vs float64: output {out['output_f32_vs_f64']:.3e}, "
          f"first training loss {out['first_loss_f32_vs_f64']:.3e}; the "
          f"card with TF32 on, from the CPU: output "
          f"{out['output_tf32']:.3e}, loss {out['first_loss_tf32']:.3e}")
    # the same f32 function summed in other orders, through 53 layers and
    # BatchNorms over 8-32 values a channel (train mode): on the CPU, f32
    # reads 2.9e-6 (output) and 9.3e-5 (loss) from float64; cuDNN's f32
    # algorithms (benchmark mode
    # takes the fastest: Winograd, FFT) read up to 5.5e-5 (output) and
    # 2.8e-4 (loss) from the CPU on an H100. TF32 moves the loss by ~2e-2:
    # each control must break its limit.
    limits = {"output": 5e-4, "first_loss": 1e-3}
    _check("output [2, 10] max_abs_err", out["output"], limits["output"])
    _check("first training loss abs_err", out["first_loss"],
           limits["first_loss"])
    for what, limit in limits.items():
        if not out[f"{what}_tf32"] > limit:
            raise SystemExit(f"the TF32 control of the {what} stays inside "
                             f"the f32 limit {limit}")
    start = cpu.params().astype(np.float64)
    losses = {"card": [], "cpu": [], "f64": []}
    for _ in range(2):
        for name, net in (("card", gpu), ("cpu", cpu), ("f64", f64)):
            net.fit(x, y)
            losses[name].append(net.score())
    print(f"  losses: {json.dumps(losses)}")
    out["losses"] = losses["card"]
    # the two steps' parameter change: the step's gradient passes 16
    # BatchNorms over 8-32 values a channel, where f32 on the CPU is ~5%
    # (relative L2) off float64; lr 0.1 then
    # takes the loss from 3.3 to ~13 in one step, so two f32 runs part
    # and a per-entry or loss comparison only measures that chaos. The
    # card's change is held to float64's as the CPU's f32 is: its relative
    # L2 error at most twice the CPU's.
    want = f64.params() - start

    def rel(net):
        return float(np.linalg.norm(net.params() - start - want)
                     / np.linalg.norm(want))

    out["update_rel_err_card"], out["update_rel_err_cpu"] = rel(gpu), rel(cpu)
    out["update_rel_card_vs_cpu"] = float(
        np.linalg.norm(gpu.params() - cpu.params())
        / np.linalg.norm(cpu.params() - start))
    print(f"  2 steps: parameter change, relative L2 error against float64:"
          f" CPU f32 {out['update_rel_err_cpu']:.3e}; card vs CPU "
          f"{out['update_rel_card_vs_cpu']:.3e}")
    _check("2 steps: the card's parameter change, relative L2 error "
           "against float64", out["update_rel_err_card"],
           max(2 * out["update_rel_err_cpu"], 1e-5))
    if not all(np.isfinite(losses["card"])):
        raise SystemExit("ResNet-50 f32 losses are not finite")
    return out


def resnet_full_width():
    """Phase 17. Returns its readings and the warmed network."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.zoo.resnet import resnet50
    # 24 warm-up steps: cuDNN's algorithm search runs in the first; and
    # lr 0.1 with momentum 0.9 from He-initialised weights makes the loss
    # of the repeated batch rise and fall for up to 13 steps (the warm-up
    # losses printed below show it) before it falls step after step
    batch, warmup, steps = 128, 24, 8
    print(f"phase 17: ResNet-50 full width, bf16, batch {batch}, 224x224x3, "
          f"1000 classes, Nesterov lr 0.1 momentum 0.9")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    net = resnet50(data_type="bfloat16")
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(17)
    # one random batch, on the card, as bench.py feeds the JAX package
    x = torch.rand((batch, 224, 224, 3), generator=gen, device="cuda")
    y = torch.nn.functional.one_hot(
        torch.randint(0, 1000, (batch,), generator=gen, device="cuda"),
        1000).float()
    ds = DataSet(x, y)
    t0 = time.perf_counter()
    warm = []
    for i in range(warmup):
        if i == warmup - 1:
            audit = _DeviceAudit()
            with audit:
                net.fit(ds)
        else:
            net.fit(ds)
        warm.append(net._score)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = [float(s) for s in warm]
    print(f"  warm-up losses {[round(l, 4) for l in warm]}")
    print(f"  init {init_s:.1f} s; {warmup} warm-up steps (cuDNN search) "
          f"{warm_s:.1f} s; audited step: {audit.ops} ops, off the card: "
          f"{sorted(audit.off_card)}")
    if audit.off_card or audit.ops == 0:
        raise SystemExit(f"the step used tensors off the card: "
                         f"{sorted(audit.off_card)}")
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    scores = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(steps):
        net.fit(ds)
        scores.append(net._score)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    losses = [float(s) for s in scores]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    mean_ms = sum(step_ms) / steps
    out = {"step_ms": step_ms, "mean_step_ms": mean_ms,
           "images_per_s": batch * 1e3 / mean_ms,
           "images_per_s_wall": batch * steps / wall_s,
           "peak_memory_gib": peak_gib, "losses": losses,
           "warmup_s": warm_s, "warmup_losses": warm, "init_s": init_s}
    print(f"  losses {[round(l, 5) for l in losses]}")
    print(f"  step ms {[round(t, 2) for t in step_ms]}; mean {mean_ms:.2f} ms,"
          f" {out['images_per_s']:.1f} images/s ({out['images_per_s_wall']:.1f}"
          f" by the host clock over the {steps} steps); peak memory "
          f"{peak_gib:.2f} GiB")
    if not all(math.isfinite(l) for l in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"ResNet-50 losses not finite and falling: {losses}")
    bad = [n for n, p in net.named_parameters()
           if p.dtype != torch.float32 or not p.is_cuda]
    if bad:
        raise SystemExit(f"parameters not f32 on the card: {bad[:5]}")
    # inference: the same batch, the running statistics
    net.output(x)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    probs = net.output(x)[0]
    end.record()
    end.synchronize()
    out["output_ms"] = start.elapsed_time(end)
    out["output_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    if (probs.shape != (batch, 1000) or not np.isfinite(probs).all()
            or _max_err(probs.sum(axis=1), np.ones(batch)) > 1e-2):
        raise SystemExit(f"bad ResNet-50 output {probs.shape}")
    print(f"  output [{batch}, 1000]: {out['output_ms']:.2f} ms "
          f"({batch * 1e3 / out['output_ms']:.1f} images/s; "
          f"{out['output_wall_ms']:.2f} ms wall with the copy to the host)")
    # where one step's device time goes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        net.fit(ds)
        torch.cuda.synchronize()
    kernels = sorted(((e.device_time_total, e.count, e.key)
                      for e in prof.key_averages() if e.device_time_total),
                     reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    out["traced_device_ms"] = busy_ms
    out["device_busy_share"] = busy_ms / mean_ms
    out["by_kind_ms"] = {}
    for us, _, name in kernels:
        kind = _kernel_kind(name)
        out["by_kind_ms"][kind] = out["by_kind_ms"].get(kind, 0.0) + us / 1e3
    out["top_kernels"] = [{"name": k[2][:90], "ms": k[0] / 1e3, "count": k[1]}
                          for k in kernels[:15]]
    print(f"  one traced step: {busy_ms:.2f} ms of device time in "
          f"{sum(k[1] for k in kernels)} kernels ({out['device_busy_share']:.1%}"
          f" of the mean step); by kind: " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in sorted(
                  out["by_kind_ms"].items(), key=lambda kv: -kv[1])))
    print("  the largest:")
    for k in out["top_kernels"]:
        print(f"    {k['ms']:8.3f} ms  x{k['count']:<4d} {k['name']}")
    return out, net


def _kernel_kind(name):
    """A device kernel's kind, from its name (cuDNN, cuBLAS and ATen's)."""
    kinds = (("pooling", ("pool",)), ("reduction", ("reduce_kernel",)),
             ("copy or cast", ("copy",)),
             ("convolution", ("fprop", "dgrad", "wgrad", "implicit", "conv",
                              "cudnn")),
             ("matrix product", ("gemm", "gemv", "xmma", "cutlass",
                                 "nvjet")),
             ("elementwise", ("elementwise",)))
    for kind, keys in kinds:
        if any(k in name for k in keys):
            return kind
    return "other"


def golden_zips_on_card():
    """Phase 18. Returns each zip's output error."""
    import numpy as np
    from deeplearning4j_tpu_torch.util import model_serializer as ms
    print("phase 18: golden model zips restored on the card")
    golden = Path(__file__).resolve().parent / "tests" / "fixtures" / "golden"
    out = {}
    for name, restore in (("mlp", ms.restore_multi_layer_network),
                          ("lenet", ms.restore_multi_layer_network),
                          ("lstm", ms.restore_multi_layer_network),
                          ("cg", ms.restore_computation_graph)):
        net = restore(str(golden / f"{name}.zip"))
        io = np.load(golden / f"{name}_io.npz")
        if net.device.type != "cuda" or not np.array_equal(net.params(),
                                                           io["params"]):
            raise SystemExit(f"{name}.zip: parameters not restored on the card")
        y = net.output(io["x"])
        y = y[0] if name == "cg" else y
        # 1e-5: the zips' outputs were computed by the JAX package on the
        # CPU in f32; cuDNN may pick Winograd or FFT algorithms, cuBLAS
        # sums the LSTM's products in another order
        out[name] = _max_err(y, io["y"])
        _check(f"{name}.zip output vs io['y']", out[name], 1e-5)
    return out


def lenet_iterators_card_vs_cpu():
    """Phase 19. Returns its readings."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import (AsyncDataSetIterator,
                                                   MnistDataSetIterator,
                                                   NormalizerMinMaxScaler)
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    print("phase 19: LeNet (MultiLayerNetwork) f32 over iterators: fit on "
          "MnistDataSetIterator (batch 64, 3 batches) + "
          "NormalizerMinMaxScaler through AsyncDataSetIterator, then "
          "evaluate; card vs CPU")

    def mnist(train, n, norm=None):
        it = MnistDataSetIterator(64, num_examples=n, train=train)
        norm = norm or NormalizerMinMaxScaler().fit(it)
        it.set_pre_processor(norm)
        return it, norm

    out = {}
    for workers in (1, 2):
        nets = {}
        for dev in ("cuda", "cpu"):
            net = lenet(device=dev, data_type="float32")
            it, norm = mnist(True, 192)
            net.fit(AsyncDataSetIterator(it, num_workers=workers,
                                         device=dev))
            if (net.conf.iteration_count, net.conf.epoch_count) != (3, 1):
                raise SystemExit(f"fit took {net.conf.iteration_count} steps"
                                 f" in {net.conf.epoch_count} epochs")
            nets[dev] = net
        out["synthetic"] = it.synthetic
        err = _max_err(nets["cuda"].params(), nets["cpu"].params())
        out[f"param_err_workers_{workers}"] = err
        # 1e-5 as phase 15: cuDNN and the CPU sum in other orders
        _check(f"num_workers={workers}: parameters after 3 steps, card vs "
               f"CPU", err, 1e-5)
    evs = {dev: net.evaluate(mnist(False, 200, norm)[0])
           for dev, net in nets.items()}
    if not np.array_equal(evs["cuda"].confusion.matrix,
                          evs["cpu"].confusion.matrix):
        raise SystemExit("evaluate: the confusion matrices differ")
    for stat in ("accuracy", "precision", "recall", "f1"):
        a, b = getattr(evs["cuda"], stat)(), getattr(evs["cpu"], stat)()
        out[stat] = a
        _check(f"evaluate {stat} {a:.6f}, card vs CPU", abs(a - b), 1e-12)
    out["examples"] = evs["cuda"].num_examples
    print(f"  evaluate: {out['examples']} examples, confusion matrices "
          f"equal (synthetic MNIST: {out['synthetic']})")
    return out


def _gpu_intervals(trace, window):
    """(kernels by stream, host-to-device copies as (stream, t0, t1)) of a
    chrome trace, clipped to window = (t0, t1), in us."""
    lo, hi = window
    kernels, copies = {}, []
    for e in trace:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy",
                                                       "gpu_memset"):
            continue
        t0, t1 = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if t1 <= t0:
            continue
        stream = e.get("args", {}).get("stream")
        if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]:
            copies.append((stream, t0, t1))
        else:
            kernels.setdefault(stream, []).append((t0, t1))
    return kernels, copies


def _union(intervals):
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def _overlap(a, union):
    return sum(max(0.0, min(a[1], u1) - max(a[0], u0)) for u0, u1 in union)


def resnet_fit_iterator(net, p17):
    """Phase 20. Returns its readings."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, record_function

    from deeplearning4j_tpu_torch.datasets import (ArraysDataSetIterator,
                                                   AsyncDataSetIterator,
                                                   DataSet,
                                                   ImagePreProcessingScaler)
    batch, steps, traced = 128, 8, 7
    print(f"phase 20: ResNet-50 bf16 full width, fit over a host iterator: "
          f"uint8 NHWC batches of {batch}x224x224x3 "
          f"({batch * 224 * 224 * 3 / 1e6:.1f} MB each) through "
          f"AsyncDataSetIterator (ImagePreProcessingScaler on the card, bf16 "
          f"wire), phase 17's warmed network")
    rng = np.random.default_rng(20)
    n = batch * (1 + steps + traced)
    x = rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, n)]
    scaler = ImagePreProcessingScaler()

    def staged(lo, hi):
        return AsyncDataSetIterator(
            ArraysDataSetIterator((x[lo:hi], y[lo:hi]), batch),
            device_transform=scaler, transfer_dtype="bfloat16",
            cast_labels=False)

    # the staged batch against the same bytes put on the card and scaled
    # there; the same weights score both the same
    ds = staged(0, batch).next()
    want = scaler.as_device_transform()(torch.from_numpy(x[:batch]).cuda())
    labels = torch.from_numpy(y[:batch]).cuda()
    same = (ds.features.dtype == want.dtype and ds.features.is_cuda
            and torch.equal(ds.features, want)
            and ds.labels.dtype == torch.float32
            and torch.equal(ds.labels, labels))
    s_staged = net.score(DataSet(ds.features, ds.labels))
    s_card = net.score(DataSet(want, labels))
    print(f"  staged batch == the batch scaled on the card, bit for bit: "
          f"{same}; score {s_staged} == {s_card}")
    if not same or s_staged != s_card:
        raise SystemExit("the staged batch differs from the on-card one")

    # the host-to-device copy of one batch, alone: pinning on the host,
    # the copy by CUDA events
    pin_ms, h2d_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        host = torch.from_numpy(x[:batch]).pin_memory()
        pin_ms.append(1e3 * (time.perf_counter() - t0))
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        host.to("cuda", non_blocking=True)
        e1.record()
        e1.synchronize()
        h2d_ms.append(e0.elapsed_time(e1))

    # does pinning on another thread hold back this one? (the interpreter
    # lock: the staging thread pins while the training thread launches)
    def progress(work):
        t = threading.Thread(target=work)
        n, t0 = 0, time.perf_counter()
        t.start()
        while t.is_alive():
            n += 1
        return n / (time.perf_counter() - t0)

    alone = progress(lambda: time.sleep(0.05))
    beside_pin = progress(lambda: [torch.from_numpy(x[:batch]).pin_memory()
                                   for _ in range(5)])
    gil_share = beside_pin / alone

    scores, marks = [], []
    step = net._step

    def timed_step(b):
        step(b)
        scores.append(net._score)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    net._step = timed_step
    it = staged(batch, batch * (1 + steps))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    net.fit(it)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip([start] + marks, marks)]
    losses = [float(s) for s in scores]
    steady = sum(step_ms[1:]) / (steps - 1)

    # a traced window: is the copy on the staging stream while a step's
    # kernels run, and how busy is the card?
    it = staged(batch * (1 + steps), n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("phase20.fit"):
            net.fit(it)
            torch.cuda.synchronize()
    del net._step
    path = Path(__file__).resolve().parent / "build" / "phase20_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    win = [e for e in trace if e.get("name") == "phase20.fit"
           and e.get("cat") == "user_annotation"]
    window = (win[0]["ts"], win[0]["ts"] + win[0]["dur"])
    kernels, copies = _gpu_intervals(trace, window)
    compute = max(kernels, key=lambda st: sum(t1 - t0 for t0, t1
                                              in kernels[st]))
    busy = _union([iv for ivs in kernels.values() for iv in ivs]
                  + [(t0, t1) for _, t0, t1 in copies])
    compute_union = _union(kernels[compute])
    side = [c for c in copies if c[0] != compute]
    # the loop's reset stages the first batches before any step runs; the
    # copies after the first step's first kernel are the steady state
    first = compute_union[0][0]
    in_steps = [c for c in side if c[1] >= first]
    copy_us = sum(t1 - t0 for _, t0, t1 in in_steps)
    overlap_us = sum(_overlap((t0, t1), compute_union)
                     for _, t0, t1 in in_steps)
    big = [t1 - t0 for _, t0, t1 in copies if t1 - t0 > 100]
    # when each batch copy ran, how busy the compute stream was then, and
    # the training thread's longest pause between ops in the 30 ms before
    main_tid = win[0]["tid"]
    main_ops = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace
                      if e.get("cat") == "cpu_op" and e.get("tid") == main_tid)

    def pause_before(t):
        ops = [o for o in main_ops if t - 30e3 <= o[0] <= t]
        ends = [o[1] for o in ops]
        return max((b[0] - max(ends[:i + 1])) for i, b in
                   enumerate(ops[1:])) / 1e3 if len(ops) > 1 else None

    detail = [{"on_card_ms": (t0 - window[0]) / 1e3, "ms": (t1 - t0) / 1e3,
               "compute_busy": _overlap((t0, t1), compute_union) / (t1 - t0),
               "main_pause_ms": pause_before(t0)}
              for _, t0, t1 in side if t1 - t0 > 100]
    out = {"step_ms": step_ms, "mean_step_ms_steady": steady,
           "images_per_s": batch * 1e3 / steady,
           "images_per_s_wall": batch * steps / wall_s,
           "phase17_images_per_s": p17["images_per_s"],
           "losses": losses, "pin_ms": sum(pin_ms) / 5,
           "h2d_ms": sum(h2d_ms) / 5,
           "h2d_ms_traced": sum(big) / 1e3 / max(1, len(big)),
           "h2d_copies_traced": len(copies),
           "h2d_on_side_stream": len(side), "compute_stream": compute,
           "h2d_during_steps": len(in_steps),
           "h2d_overlapped_share": overlap_us / copy_us if copy_us else 0.0,
           "device_busy_share": sum(t1 - t0 for t0, t1 in busy)
           / (window[1] - window[0]),
           "traced_window_ms": (window[1] - window[0]) / 1e3,
           "bit_equal_staged": same, "copies": detail,
           "main_thread_rate_beside_pin": gil_share}
    print(f"  losses {[round(l, 4) for l in losses]}")
    print(f"  step ms {[round(t, 2) for t in step_ms]} (the first waits for "
          f"the iterator's reset and first batch); steps 2-{steps}: "
          f"{steady:.2f} ms, {out['images_per_s']:.1f} images/s "
          f"({out['images_per_s_wall']:.1f} by the host clock over all "
          f"{steps}); phase 17, one batch kept on the card: "
          f"{p17['images_per_s']:.1f} images/s")
    print(f"  host to device, one batch: pin_memory {out['pin_ms']:.2f} ms "
          f"(host), copy {out['h2d_ms']:.3f} ms (CUDA events), "
          f"{out['h2d_ms_traced']:.3f} ms in the trace")
    print(f"  traced window of {traced} steps, {out['traced_window_ms']:.1f} "
          f"ms: {len(copies)} host-to-device copies, {len(side)} on a stream "
          f"other than the compute stream {compute}; of the {len(in_steps)} "
          f"issued while steps run, {out['h2d_overlapped_share']:.1%} of "
          f"their time overlaps compute kernels; device busy "
          f"{out['device_busy_share']:.1%}")
    print("  each batch copy (start ms in the window, ms, compute stream "
          "busy meanwhile, the training thread's longest pause between ops "
          "in the 30 ms before, ms): " + ", ".join(
              f"({d['on_card_ms']:.1f}, {d['ms']:.3f}, "
              f"{d['compute_busy']:.0%}, {d['main_pause_ms']})"
              for d in detail))
    print(f"  a Python loop on this thread runs at {gil_share:.1%} of its "
          f"rate while another thread pins batches")
    if not all(math.isfinite(l) for l in losses) or len(losses) != steps:
        raise SystemExit(f"fit over the iterator: losses {losses}")
    if not in_steps:
        raise SystemExit("no host-to-device copy ran on the staging stream "
                         "while the steps ran")
    return out


def resnet_inference_server(net):
    """Phase 21. Returns its readings."""
    import numpy as np

    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    from deeplearning4j_tpu_torch.models.zoo.resnet import resnet50
    from deeplearning4j_tpu_torch.serving import (InferenceServer,
                                                  UnhealthyOutputError)
    from deeplearning4j_tpu_torch.common.device import to_public
    buckets, n_req, clients = (2, 4, 8, 16, 32), 256, 8
    print(f"phase 21: InferenceServer serving ResNet-50 bf16 at 224x224x3: "
          f"max_batch 32, buckets {buckets}, {clients} client threads, "
          f"{n_req} single-image requests, a hot swap mid-stream")
    rng = np.random.default_rng(21)
    xs = rng.random((n_req, 224, 224, 3), dtype=np.float32)
    net2 = resnet50(data_type="bfloat16", seed=124)

    # cross-bucket: a row's pooled features (the fc layer's input) and its
    # output at each bucket size against the same row at 32 (cuDNN searches
    # an algorithm for each shape)
    def rows(b):
        acts = net.feed_forward(xs[:b])
        return acts["avgpool"], acts["fc"]

    feat32, out32 = rows(32)
    cross = {}
    for b in buckets:
        feat, prob = rows(b)
        rel = (np.linalg.norm((feat - feat32[:b]).reshape(b, -1), axis=1)
               / np.linalg.norm(feat32[:b].reshape(b, -1), axis=1))
        cross[b] = {
            "bit_equal": bool(np.array_equal(feat, feat32[:b])
                              and np.array_equal(prob, out32[:b])),
            "features_max_abs_diff": _max_err(feat, feat32[:b]),
            "features_row_rel_err": float(rel.max()),
            "features_max_abs": float(np.abs(feat32[:b]).max()),
            "max_abs_diff": _max_err(prob, out32[:b]),
            "top1_equal": bool((prob.argmax(1) == out32[:b].argmax(1)).all())}
    top = float(out32.max(axis=1).mean())
    print(f"  rows across buckets vs bucket 32 (pooled features, then "
          f"probabilities; the mean top probability is {top:.3f}): "
          + ", ".join(f"{b}: {'bits equal' if c['bit_equal'] else 'differ'} "
                      f"{c['features_max_abs_diff']:.3e} of "
                      f"{c['features_max_abs']:.3e} (row rel. L2 "
                      f"{c['features_row_rel_err']:.3e}) "
                      f"{c['max_abs_diff']:.3e}" for b, c in cross.items()))

    srv = InferenceServer(net, max_batch=32, buckets=buckets,
                          max_wait_ms=5.0, max_queue=1024,
                          screen_outputs=True)
    infer = srv._infer
    log = []
    # keep each dispatch's pooled features (the fc layer's input), read
    # from the dispatch's own forward: both versions run through `net`'s
    # inference step, so its graph walk sees every dispatch
    keep = threading.local()
    apply_graph = net._apply_graph

    def apply_and_keep(*args, **kwargs):
        res = apply_graph(*args, **kwargs)
        if getattr(keep, "feats", None) is not None:
            keep.feats.append(res[0]["avgpool"])
        return res

    net._apply_graph = apply_and_keep

    def logged(params, state, x):
        t0 = time.perf_counter()
        keep.feats = []
        out = infer(params, state, x)
        feat, keep.feats = keep.feats[0], None
        log.append((id(params), x, out, feat,
                    1e3 * (time.perf_counter() - t0)))
        return out

    srv._infer = logged
    versions = {id(srv._params_ref[0]): (1, net)}
    params, state = srv._params_ref
    bucket_ms = {}
    for b in buckets:
        xb = xs[:b]
        for _ in range(2):
            infer(params, state, xb)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        e0.record()
        for _ in range(5):
            infer(params, state, xb)
        e1.record()
        e1.synchronize()
        bucket_ms[b] = e0.elapsed_time(e1) / 5
    print("  one dispatch (numpy batch in, H2D, forward) by CUDA events: "
          + ", ".join(f"{b}: {ms:.2f} ms ({b * 1e3 / ms:.0f} images/s)"
                      for b, ms in bucket_ms.items()))

    srv.start()
    # cuDNN keeps its searched plans per thread: the batcher thread's first
    # dispatch of each bucket searches again (~1 s). Warm-up traffic, off
    # the clock: a burst of b requests per bucket b
    warm_ms = {}
    for b in buckets:
        t_warm = time.perf_counter()
        for f in [srv.submit(x * np.float32(0.5)) for x in xs[:b]]:
            f.result(300)
        warm_ms[b] = 1e3 * (time.perf_counter() - t_warm)
    warm_log = len(log)
    futs = [None] * n_req
    done_at = [None] * n_req
    submitted = [0]
    lock = threading.Lock()

    def client(c):
        crng = np.random.default_rng(100 + c)
        mine = list(range(c, n_req, clients))
        while mine:
            burst = int(crng.integers(1, 7))
            for i in mine[:burst]:
                t_sub = time.perf_counter()
                futs[i] = srv.submit(xs[i])
                futs[i].add_done_callback(
                    lambda f, i=i, t=t_sub: done_at.__setitem__(
                        i, 1e3 * (time.perf_counter() - t)))
                with lock:
                    submitted[0] += 1
            mine = mine[burst:]
            time.sleep(float(crng.uniform(0.002, 0.010)))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    while submitted[0] < n_req // 2:
        time.sleep(0.001)
    srv.swap(net2)
    versions[id(srv._params_ref[0])] = (2, net2)
    for t in threads:
        t.join(300)
    results, errors = [None] * n_req, []
    for i, f in enumerate(futs):
        try:
            results[i] = f.result(300)
        except Exception as e:          # counted and reported below
            errors.append((i, repr(e)))
    wall_s = time.perf_counter() - t0
    snap = srv.metrics.snapshot()

    first_pass = log[warm_log:]

    # a NaN request fails alone; its neighbours and the server go on
    bad = xs[:4].copy()
    bad[1, 5, 5, 0] = np.nan
    nan_futs = [srv.submit(b) for b in bad]
    nan_failed = []
    for i, f in enumerate(nan_futs):
        try:
            f.result(120)
        except UnhealthyOutputError:
            nan_failed.append(i)
    # the same images again, in another order and other company
    second_start = len(log)
    order = rng.permutation(n_req)
    again = {}
    for lo in range(0, n_req, 48):
        batch_ids = order[lo:lo + 48]
        for i, f in [(i, srv.submit(xs[i])) for i in batch_ids]:
            again[i] = f.result(300)
    srv.stop()
    del net._apply_graph
    if errors or snap.get("failed", 0) or nan_failed != [1]:
        raise SystemExit(f"serving: errors {errors[:3]}, failed "
                         f"{snap.get('failed')}, NaN failures {nan_failed}")

    def rows_by_image(entries):
        found = {}
        for pid, x, out, *_ in entries:
            for r, img in zip(to_public(out[0]), x):
                found.setdefault(hash(img.tobytes()), []).append(
                    (versions[pid][0], r, len(x)))
        return found

    def served_as(found, i, res):
        """(version, bucket) of the dispatch row equal to the result."""
        cands = [(v, b) for v, r, b in found.get(hash(xs[i].tobytes()), [])
                 if np.array_equal(r, res[0])]
        if not cands:
            raise SystemExit(f"request {i}: no dispatch row equals its "
                             f"result")
        return cands[0]

    first, second = rows_by_image(first_pass), rows_by_image(
        log[second_start:])
    served, bucket_count, same_bucket = {1: 0, 2: 0}, {}, 0
    for i, res in enumerate(results):
        v, b = served_as(first, i, res)
        served[v] += 1
        bucket_count[b] = bucket_count.get(b, 0) + 1
        v2, b2 = served_as(second, i, again[i])
        # within a bucket, on the server's thread: bit for bit
        if v == v2 == 2 and b == b2:
            same_bucket += 1
            if not np.array_equal(res[0], again[i][0]):
                raise SystemExit(f"request {i}: bucket {b} served it with "
                                 f"other bits in other company")
    if not served[1] or not served[2] or same_bucket < 32:
        raise SystemExit(f"the swap was not mid-stream ({served}) or too "
                         f"few repeats in one bucket ({same_bucket})")
    # every dispatch against output()'s forward of the same padded batch
    # under the version that served it, on this thread. cuDNN searched its
    # plans here apart from the batcher thread, so the trunk may round
    # apart by bf16 ulps: the fc layer's input is held as across buckets
    # (a padding row's pooled features are all zero: there it must be
    # equal). A saturated softmax (phase 17's network reads a mean top
    # probability of 1.000) turns one ulp of a logit at a near-tie of the
    # top two classes into a probability swing of up to 1, so the
    # probabilities are held on the rows whose pooled features are
    # bit-equal, where the head reads the same input
    rels, sames, errs, rows = [], [], [], []
    vs_output_bits = 0
    for pid, x, out, feat, _ in first_pass:
        acts = versions[pid][1]._forward((x,), False)
        got_f = np.asarray(to_public(feat), np.float64).reshape(len(x), -1)
        want_f = np.asarray(to_public(acts["avgpool"]),
                            np.float64).reshape(len(x), -1)
        got, want = to_public(out[0]), to_public(acts["fc"])
        del acts
        diff = np.linalg.norm(got_f - want_f, axis=1)
        norm = np.linalg.norm(want_f, axis=1)
        rels.append(np.divide(diff, norm, where=norm > 0,
                              out=np.where(diff == 0, 0.0, np.inf)))
        sames.append((got_f == want_f).all(1))
        errs.append(np.abs(np.asarray(got, np.float64)
                           - np.asarray(want, np.float64)).max(1))
        rows += [(len(x), versions[pid][0], r, got[r], want[r])
                 for r in range(len(x))]
        vs_output_bits += bool(np.array_equal(got, want))
    rel, same, err = (np.concatenate(a) for a in (rels, sames, errs))
    vs_feat, vs_output_all = float(rel.max()), float(err.max())
    vs_output = float(err[same].max()) if same.any() else 0.0
    rows_same, rows_all = int(same.sum()), len(same)
    w = int(err.argmax())
    lat = sorted(done_at)
    host_ms = [ms for *_, ms in first_pass]
    out = {"requests": n_req, "wall_s": wall_s,
           "images_per_s": n_req / wall_s,
           "latency_ms_p50": lat[n_req // 2],
           "latency_ms_p99": lat[min(n_req - 1, int(0.99 * n_req))],
           "server_latency_ms_p50": snap.get("latency_ms_p50"),
           "server_latency_ms_p99": snap.get("latency_ms_p99"),
           "warmup_burst_ms": warm_ms,
           "dispatch_host_ms": host_ms,
           "batch_size_mean": snap.get("batch_size_mean"),
           "batch_occupancy_mean": snap.get("batch_occupancy_mean"),
           "dispatches": len(first_pass), "served_by_version": served,
           "requests_by_bucket": dict(sorted(bucket_count.items())),
           "bucket_dispatch_ms": bucket_ms, "cross_bucket": cross,
           "mean_top_probability": top,
           "repeats_in_one_bucket_bit_equal": same_bucket,
           "vs_output_features_row_rel_err": vs_feat,
           "vs_output_rows_features_bit_equal": [rows_same, rows_all],
           "vs_output_max_abs_diff": vs_output,
           "vs_output_max_abs_diff_all_rows": vs_output_all,
           "vs_output_bit_equal_dispatches": vs_output_bits,
           "programs": len(srv.compiled_programs), "swaps": snap.get("swaps")}
    print(f"  warm-up bursts through the batcher thread, ms: "
          f"{ {b: round(ms, 1) for b, ms in warm_ms.items()} }; host ms of "
          f"each timed dispatch call {[round(ms, 1) for ms in host_ms]}")
    print(f"  {n_req} requests in {wall_s:.2f} s ({out['images_per_s']:.1f} "
          f"images/s), latency p50 {out['latency_ms_p50']:.1f} ms, p99 "
          f"{out['latency_ms_p99']:.1f} ms, {out['dispatches']} dispatches, "
          f"mean batch "
          f"{out['batch_size_mean']}, requests by bucket "
          f"{out['requests_by_bucket']}; served by version {served}; 0 "
          f"dropped; a NaN request failed alone")
    print(f"  every result equals its dispatch's row; {same_bucket} images "
          f"served twice by one bucket in other company: bit-equal; the "
          f"{len(first_pass)} dispatches against output() of the same padded "
          f"batch under their version on this thread: {vs_output_bits} "
          f"bit-equal; {rows_same} of {rows_all} rows with bit-equal pooled "
          f"features; probabilities over every row, max abs diff "
          f"{vs_output_all:.3e}")
    # across buckets and threads the same function runs on other cuDNN
    # plans: the top class agrees, the rest stays within bf16's rounding
    if not all(c["top1_equal"] for c in cross.values()):
        raise SystemExit(f"top-1 class differs across buckets: {cross}")
    _check("pooled features across buckets, row rel. L2",
           max(c["features_row_rel_err"] for c in cross.values()),
           CROSS_PLAN_RTOL)
    _check("probabilities across buckets, max abs diff",
           max(c["max_abs_diff"] for c in cross.values()), CROSS_PLAN_ATOL)
    if not vs_output_all == 0:
        b, v, row, got_row, want_row = rows[w]
        print(f"  the row of the largest probability diff: bucket {b}, model "
              f"version {v}, row {row}, pooled features "
              f"{'bit-equal' if same[w] else f'row rel. L2 {rel[w]:.3e}'}, "
              f"top two probabilities: dispatch "
              f"{np.sort(got_row)[-2:].tolist()}, output() "
              f"{np.sort(want_row)[-2:].tolist()}")
    _check("server dispatches vs output() on another thread, pooled features "
           "row rel. L2", vs_feat, CROSS_PLAN_RTOL)
    _check("server dispatches vs output() on another thread, probabilities "
           "on rows with bit-equal pooled features, max abs diff",
           vs_output, CROSS_PLAN_ATOL)

    # swap_from_path: the golden LeNet zip on a LeNet server on the card
    golden = Path(__file__).resolve().parent / "tests" / "fixtures" / "golden"
    io = np.load(golden / "lenet_io.npz")
    with InferenceServer(lenet(), max_batch=8, max_wait_ms=20.0) as lsrv:
        lsrv.swap_from_path(str(golden / "lenet.zip"))
        got = np.stack([f.result(120) for f in
                        [lsrv.submit(r) for r in io["x"]]])
    out["golden_lenet_err"] = _max_err(got, io["y"])
    _check("swap_from_path(golden lenet.zip) output vs io['y']",
           out["golden_lenet_err"], 1e-5)
    del net2, srv
    return out


def training_core_phases(fa):
    """Phases 15-21 (no kernel of the port on their path). Returns the
    readings of 15-18 and of 19-21."""
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.reset_launches()
    core = {"lenet_f32": lenet_card_vs_cpu(),
            "resnet50_f32_64px": resnet_f32_card_vs_cpu()}
    core["resnet50_bf16_full"], r50 = resnet_full_width()
    core["golden_zips_err"] = golden_zips_on_card()
    serving = {"lenet_iterators": lenet_iterators_card_vs_cpu(),
               "resnet50_fit_iterator": resnet_fit_iterator(
                   r50, core["resnet50_bf16_full"]),
               "inference_server": resnet_inference_server(r50)}
    del r50
    torch.cuda.empty_cache()
    if any(fa.launches.values()):
        raise SystemExit(f"the training core launched flash kernels: "
                         f"{fa.launches}")
    if not torch.backends.cudnn.allow_tf32:
        raise SystemExit("the port left cudnn.allow_tf32 off")
    print(f"  phases 15-21 launched no kernel of the port: {fa.launches}")
    return core, serving


# Phase 22: the TransformerLM's continuous-batching decode server at the
# FULL width (bf16). Fixed slots: 16 x max_len 8192 rows; the paged arena
# holds the same bytes (8192 blocks of 16 rows) for 64 slots of up to 80
# blocks (1280 rows) each.
DS_SLOTS, DS_BUCKETS, DS_REQUESTS, DS_K = 16, (64, 256, 1024), 128, 8
DS_PAGED = dict(paged=True, block_size=16, slots=64,
                n_blocks=DS_SLOTS * FULL["max_len"] // 16,
                max_blocks_per_slot=80)
DS_CHUNK = 256
DS_SEED = 22


def _warm(srv, k=1):
    """A bucket-long prompt per prompt bucket through the server's own
    thread (the first dispatch of each shape there: cuBLAS's handles and
    workspaces are per thread), each decoding far enough to run the step
    (and, with fused windows, to capture and replay the window)."""
    vocab = FULL["vocab_size"]
    for b in srv.prompt_buckets:
        srv.generate([(7 * i + b) % vocab for i in range(b)], 2 * k + 2,
                     timeout=600)


def _recording_submit(futs):
    """A run_load `submit` that keeps each (item, future)."""
    def submit(server, item):
        kw = {"klass": item["klass"]} if "klass" in item else {}
        f = server.submit(list(item["prompt"]), item["max_new"], **kw)
        futs.append((item, f))
        return f, item["max_new"]
    return submit


def _first_divergence(a, b):
    """(tokens equal, index of the first differing token or None)."""
    n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if n is None and len(a) != len(b):
        n = min(len(a), len(b))
    return n is None, n


def _delta(snap, base, key):
    return snap.get(key, 0) - base.get(key, 0)


def _load_summary(res, snap, base):
    """The readings of one run_load pass."""
    toks = _delta(snap, base, "tokens_out")
    return {
        "completed": res["completed"], "failed": res["failed"],
        "shed_at_submit": res["shed_at_submit"],
        "tokens_out": res["tokens_out"],
        "tokens_per_s": res["tokens_per_sec"],
        "duration_s": res["duration_s"],
        "latency_ms_p50": res["latency_ms"]["p50"],
        "latency_ms_p99": res["latency_ms"]["p99"],
        "ttft_ms_p50": res.get("ttft_ms_p50"),
        "ttft_ms_p99": res.get("ttft_ms_p99"),
        "inter_token_ms_p50": res.get("inter_token_ms_p50"),
        "inter_token_ms_p99": res.get("inter_token_ms_p99"),
        "dispatches": _delta(snap, base, "dispatches"),
        "decode_iterations": _delta(snap, base, "decode_iterations"),
        "chunk_dispatches": _delta(snap, base, "chunk_dispatches"),
        "dispatches_per_token": (_delta(snap, base, "dispatches") / toks
                                 if toks else None),
        "offered_rps": res["schedule"]["offered_rps"],
        "schedule_digest": res["schedule"]["digest"]}


def _serve_load(srv, sched, deadlines=False):
    """run_load over `srv`, keeping every completed stream. Returns
    (readings, [(item, tokens)]). Without deadlines no request may fail;
    with them, a request may miss its deadline (counted, not raised)."""
    from deeplearning4j_tpu_torch.serving import (DeadlineExceededError,
                                                  run_load)
    futs = []
    base = srv.metrics.snapshot()
    res = run_load(srv, sched, submit=_recording_submit(futs),
                   result_timeout=600)
    snap = srv.metrics.snapshot()
    errors = [f.exception(0) for _, f in futs if f.exception(0)]
    if errors and not (deadlines and all(
            isinstance(e, DeadlineExceededError) for e in errors)):
        raise SystemExit(f"{len(errors)} requests failed: {errors[0]!r}")
    streams = [(item, f.result(0)) for item, f in futs
               if not f.exception(0)]
    return _load_summary(res, snap, base), streams


def _class_ttft_server():
    """A ContinuousDecodeServer that keeps each completed request's
    time to first token by request class (phase 22's overload item)."""
    from deeplearning4j_tpu_torch.serving import ContinuousDecodeServer

    class ClassTTFT(ContinuousDecodeServer):
        def _complete(self, req, t_now):
            self.ttft_by_class.setdefault(req.klass, []).append(
                (req.t_first_tok - req.t_submit) * 1e3)
            super()._complete(req, t_now)

    def make(*args, **kw):
        srv = ClassTTFT(*args, **kw)
        srv.ttft_by_class = {}
        return srv
    return make


def _p(values, q):
    from deeplearning4j_tpu_torch.obs.registry import percentile
    return percentile(sorted(values), q) if values else None


def _kernel_breakdown(fn, iters=5, top=6):
    """Device time of fn() from a torch.profiler trace of `iters` calls
    after one warm-up: ms per call in all, the busy share of the traced
    window, and the `top` kernels by device time (ms per call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_time_total > 0
            and not e.key.startswith(("cudaMemcpy", "Memcpy", "Memset"))]
    total = sum(e.device_time_total for e in kern) / 1e3
    kern.sort(key=lambda e: -e.device_time_total)
    return {"device_ms": total / iters if total else None,
            "busy_share": total / wall_ms if total else None,
            "top_kernels_ms": [(e.key[:60], e.device_time_total / 1e3 / iters)
                               for e in kern[:top]]}


def _step_ms(srv):
    """Device ms of one decode iteration of `srv` (all slots computed, no
    slot active, so nothing is written) by CUDA events, and its kernels
    from a trace."""
    aux, blocks = srv.current_params()
    idle = torch.zeros(srv.slots, dtype=torch.bool, device="cuda")
    tok = torch.zeros(srv.slots, dtype=torch.int64, device="cuda")
    args = ((srv._cache, torch.as_tensor(srv._btabs, device="cuda"))
            if srv.paged else (srv._cache,))
    step = lambda: srv._step(aux, blocks, *args, srv._pos, tok, idle)
    return cuda_ms(step, iters=20, warmup=3), _kernel_breakdown(step)


def _chunk_ms(srv):
    """Device ms of one chunk dispatch of a fixed-slot chunked server (all
    slots computed over the whole window, none active) by CUDA events."""
    aux, blocks = srv.current_params()
    S, C = srv.slots, srv._chunk
    toks = torch.zeros(S, C, dtype=torch.int64, device="cuda")
    nrows = torch.full((S,), C, dtype=torch.int64, device="cuda")
    idle = torch.zeros(S, dtype=torch.bool, device="cuda")
    return cuda_ms(lambda: srv._chunk_step(aux, blocks, srv._cache, srv._pos,
                                           toks, nrows, idle),
                   iters=5, warmup=2)


def _prefill_ms(srv):
    """Device ms of the one-shot prefill at each prompt bucket (a
    bucket-long prompt) by CUDA events."""
    aux, blocks = srv.current_params()
    prog = srv._make_prefill()
    out = {}
    for b in srv.prompt_buckets:
        x = torch.arange(b, device="cuda")[None] % FULL["vocab_size"]
        out[b] = cuda_ms(lambda: prog(aux, blocks, x, b), iters=10)
    return out


def _window_vs_steps(srv, seed):
    """A fused window captured as a CUDA graph against K plain steps of
    the same server's programs, on two copies of its cache: tokens and
    every cache byte bit-equal; each timed by CUDA events."""
    from deeplearning4j_tpu_torch.serving.decode import _CapturedWindow
    aux, blocks = srv.current_params()
    S = srv.slots
    gen = torch.Generator().manual_seed(seed)
    if srv.paged:
        nb = srv._nb_slot
        btabs = (torch.arange(S * nb).reshape(S, nb) % srv._n_blocks).cuda()
        pos = torch.randint(64, nb * 16 - DS_K, (S,), generator=gen).cuda()
        extra = {"btabs": btabs}
        wto = {"wto": pos + DS_K}
    else:
        pos = torch.randint(64, FULL["max_len"] - DS_K, (S,),
                            generator=gen).cuda()
        extra, wto = {}, {}
    tok = torch.randint(0, FULL["vocab_size"], (S,), generator=gen).cuda()
    active = torch.ones(S, dtype=torch.bool, device="cuda")
    steps = torch.full((S,), DS_K, dtype=torch.int64, device="cuda")
    # the cache rows the window reads: random, so every slot attends to
    # values, not zeros
    cuda_gen = torch.Generator(device="cuda").manual_seed(seed)
    cache_g = [{n: torch.randn(c[n].shape, generator=cuda_gen,
                               device="cuda", dtype=c[n].dtype)
                for n in ("k", "v")} for c in srv._cache]
    cache_e = [{n: c[n].clone() for n in ("k", "v")} for c in cache_g]
    values = dict(extra, pos=pos, tok=tok, active=active, steps=steps, **wto)
    names = list(values)

    def run(st):
        toks, _, p = srv._window_step(aux, blocks, cache_g,
                                      *[st[n] for n in names])
        return toks, p

    g = _CapturedWindow(run, {n: t.clone() for n, t in values.items()})
    toks_g, pos_g = g.replay(values)
    torch.cuda.synchronize()

    def eager():
        p, t, out = pos, tok, []
        for i in range(DS_K):
            act = active & (steps > i)
            if srv.paged:
                act = act & (p < wto["wto"])
                nxt, _, _, p2 = srv._step(aux, blocks, cache_e, btabs, p, t,
                                          act)
            else:
                nxt, _, _, p2 = srv._step(aux, blocks, cache_e, p, t, act)
            out.append(nxt)
            t = torch.where(act, nxt, t)
            p = p2
        return torch.stack(out), p

    toks_e, pos_e = eager()
    torch.cuda.synchronize()
    # every cache row but the spare one past the end, which the capture's
    # warm-up (all slots inactive) wrote and no read covers
    equal = (torch.equal(toks_g, toks_e) and torch.equal(pos_g, pos_e)
             and all(torch.equal(a[n][:-1], b[n][:-1])
                     for a, b in zip(cache_g, cache_e) for n in ("k", "v")))
    window_ms = cuda_ms(lambda: g.replay(values), iters=20, warmup=2)
    steps_ms = cuda_ms(eager, iters=20, warmup=2)
    del cache_g, cache_e, g
    torch.cuda.empty_cache()
    return {"bit_equal": equal, "window_ms": window_ms,
            "plain_steps_ms": steps_ms}


def _step_logits_rel_err(lm, prompt):
    """The first decode step's f32 logits for one prompt, from identical
    prefill rows, through the fixed program (16 slots, 8192-row window)
    and the paged one (64 slots, 1280-row window): relative L2 error."""
    from deeplearning4j_tpu_torch.models.zoo import transformer as T
    H, L, D = FULL["n_heads"], FULL["n_layers"], FULL["d_model"]
    aux, blocks = lm.aux, list(lm.blocks)
    P = len(prompt)
    padded = torch.zeros(1, DS_BUCKETS[-1], dtype=torch.int64, device="cuda")
    padded[0, :P] = torch.tensor(prompt)
    logits, rows = T.make_prefill_fn(H, FULL["max_len"])(aux, blocks, padded,
                                                         P)
    first = logits[0].argmax()
    out = []
    for paged in (False, True):
        S = DS_PAGED["slots"] if paged else DS_SLOTS
        pos = torch.zeros(S, dtype=torch.int64, device="cuda")
        tok = torch.zeros(S, dtype=torch.int64, device="cuda")
        act = torch.zeros(S, dtype=torch.bool, device="cuda")
        pos[0], tok[0], act[0] = P, first, True
        if paged:
            nb = DS_PAGED["max_blocks_per_slot"]
            cache = T.init_paged_kv_cache(L, S * nb, 16, D, H, torch.bfloat16,
                                          "cuda")
            btabs = torch.arange(S * nb, device="cuda").reshape(S, nb)
            _, panels = T.make_paged_prefill_fn(H)(aux, blocks, padded, P)
            T.make_paged_install_fn(16)(cache, panels, btabs[0], P, 0)
            _, lg, _, _ = T.make_paged_decode_fn(H, 16)(
                aux, blocks, cache, btabs, pos, tok, act)
        else:
            cache = T.init_slot_kv_cache(L, S, FULL["max_len"], D, H,
                                         torch.bfloat16, "cuda")
            for c, r in zip(cache, rows):
                c["k"][0].copy_(r["k"][0])
                c["v"][0].copy_(r["v"][0])
            _, lg, _, _ = T.make_slot_decode_fn(H)(aux, blocks, cache, pos,
                                                   tok, act)
        out.append(lg[0])
        del cache
    torch.cuda.empty_cache()
    return float((out[1] - out[0]).norm() / out[0].norm())


@torch.no_grad()
def decode_serving_phase(fa):
    """Phase 22. Returns its readings."""
    from deeplearning4j_tpu_torch.models.zoo import transformer as T
    from deeplearning4j_tpu_torch.models.zoo.transformer import TransformerLM
    from deeplearning4j_tpu_torch.serving import (BrownoutPolicy,
                                                  ContinuousDecodeServer,
                                                  DecodeSizeMix,
                                                  OnOffProcess,
                                                  PoissonProcess,
                                                  SharedPrefixMix,
                                                  build_schedule)
    print(f"phase 22: ContinuousDecodeServer on the TransformerLM at full "
          f"width (bf16, vocab {FULL['vocab_size']}, d_model "
          f"{FULL['d_model']}, {FULL['n_heads']} heads, {FULL['n_layers']} "
          f"layers, max_len {FULL['max_len']}), traffic from loadgen")
    t_phase = time.perf_counter()
    fa.reset_launches()
    out = {}
    lm = TransformerLM(**FULL, dtype=torch.bfloat16, device="cuda")
    vocab = FULL["vocab_size"]
    mix = DecodeSizeMix(((1.0, (16, 1024), (16, 256)),), vocab=vocab)
    mean_new = (16 + 256) / 2

    # 1. fixed slots, continuous against static
    srv = ContinuousDecodeServer(lm, slots=DS_SLOTS,
                                 prompt_buckets=DS_BUCKETS,
                                 max_queue=DS_REQUESTS).start()
    try:
        t0 = time.perf_counter()
        _warm(srv)
        warm_s = time.perf_counter() - t0
        step_ms, step_trace = _step_ms(srv)
        prefill_ms = _prefill_ms(srv)
        # offered: 60% of what the step alone could decode at full slots
        rate = 0.6 * DS_SLOTS / (step_ms / 1e3) / mean_new
        sched = build_schedule(PoissonProcess(rate), mix, DS_REQUESTS,
                               seed=DS_SEED)
        fixed, streams = _serve_load(srv, sched)
        fixed.update(step_ms=step_ms, step_trace=step_trace,
                     prefill_ms=prefill_ms, warm_s=warm_s, rate_rps=rate)
        # join == solo on the card: 8 co-batched streams served again alone
        solo = [srv.generate(list(item["prompt"]), item["max_new"],
                             timeout=600) for item, _ in streams[:8]]
        fixed["join_equals_solo"] = all(
            s == t for s, (_, t) in zip(solo, streams[:8]))
        probe = [list(item["prompt"]) for item, _ in streams[:8]]
        probe_fixed = [srv.generate(p, 32, timeout=600) for p in probe]
    finally:
        srv.stop()
    print(f"  fixed, {DS_SLOTS} slots, buckets {DS_BUCKETS}: decode "
          f"iteration {step_ms:.3f} ms (CUDA events), offered "
          f"{rate:.1f} requests/s: {fixed['tokens_per_s']} tokens/s, TTFT "
          f"p50/p99 {fixed['ttft_ms_p50']}/{fixed['ttft_ms_p99']} ms, "
          f"inter-token p50/p99 {fixed['inter_token_ms_p50']}/"
          f"{fixed['inter_token_ms_p99']} ms, "
          f"{fixed['dispatches_per_token']:.4f} dispatches/token; join == "
          f"solo on 8 streams: {fixed['join_equals_solo']}")
    print(f"  one decode iteration traced: {step_trace}; one-shot prefill "
          f"by bucket (CUDA events): "
          f"{ {b: round(t, 3) for b, t in prefill_ms.items()} } ms")
    if not fixed["join_equals_solo"]:
        raise SystemExit("a co-batched stream differs from its solo run")
    srv = ContinuousDecodeServer(lm, slots=DS_SLOTS,
                                 prompt_buckets=DS_BUCKETS,
                                 max_queue=DS_REQUESTS,
                                 static_batching=True).start()
    try:
        _warm(srv)
        static, _ = _serve_load(srv, sched)
    finally:
        srv.stop()
    ratio = fixed["tokens_per_s"] / static["tokens_per_s"]
    print(f"  static batching, same traffic: {static['tokens_per_s']} "
          f"tokens/s, TTFT p99 {static['ttft_ms_p99']} ms; continuous / "
          f"static {ratio:.2f}x")
    out["fixed"], out["static"] = fixed, static
    out["continuous_over_static"] = ratio

    # 2. paged, equal arena bytes, shared prefixes
    srv = ContinuousDecodeServer(lm, prompt_buckets=DS_BUCKETS,
                                 max_queue=DS_REQUESTS, **DS_PAGED).start()
    try:
        _warm(srv)
        pmix = SharedPrefixMix(n_prefixes=4, prefix_blocks=(16, 32),
                               block_size=16, suffix=(1, 64), new=(16, 256),
                               vocab=vocab, seed=DS_SEED)
        psched = build_schedule(PoissonProcess(2 * rate), pmix, DS_REQUESTS,
                                seed=DS_SEED)
        paged, _ = _serve_load(srv, psched)
        snap = srv.metrics.snapshot()
        paged_step_ms, paged_trace = _step_ms(srv)
        paged.update(step_ms=paged_step_ms, step_trace=paged_trace,
                     live_streams_max=snap.get("live_streams_max"),
                     prefix_rows_hit=snap.get("prefix_rows_hit", 0),
                     prefix_hit_rate=snap.get("prefix_hit_rate"),
                     cow_copies=snap.get("cow_copies", 0),
                     pool_check=bool(srv._pool.check()),
                     blocks_in_use_after=srv._pool.blocks_in_use)
        probe_paged = [srv.generate(p, 32, timeout=600) for p in probe]
    finally:
        srv.stop()
    print(f"  paged, {DS_PAGED['slots']} slots, {DS_PAGED['n_blocks']} "
          f"blocks of 16 (the fixed arena's bytes): most live streams "
          f"{paged['live_streams_max']}, prefix rows hit "
          f"{paged['prefix_rows_hit']} (rate {paged['prefix_hit_rate']}), "
          f"{paged['tokens_per_s']} tokens/s, decode iteration "
          f"{paged['step_ms']:.3f} ms; pool check "
          f"{paged['pool_check']}, blocks in use after "
          f"{paged['blocks_in_use_after']}; traced iteration "
          f"{paged_trace}")
    if not paged["pool_check"] or paged["blocks_in_use_after"]:
        raise SystemExit("the block pool leaked")
    out["paged"] = paged

    # 3. overload: an on/off burst above item 1's rate, two classes
    omix = DecodeSizeMix(((0.5, (16, 128), (16, 64), "interactive"),
                          (0.5, (512, 1024), (64, 256), "batch")),
                         vocab=vocab)
    osched = build_schedule(OnOffProcess(3 * rate, 1.0, 1.0), omix,
                            DS_REQUESTS, seed=DS_SEED)
    make = _class_ttft_server()
    out["overload"] = {}
    for label, chunk in (("chunked", DS_CHUNK), ("one_shot", None)):
        srv = make(lm, slots=DS_SLOTS, prompt_buckets=DS_BUCKETS,
                   max_queue=64, chunked_prefill=chunk, admission=True,
                   brownout=BrownoutPolicy(
                       classes={"interactive": (1.01, 1.01),
                                "batch": (0.25, 0.75)}),
                   default_deadline_ms=5000.0).start()
        try:
            _warm(srv)
            srv.ttft_by_class.clear()
            res, _ = _serve_load(srv, osched, deadlines=True)
            snap = srv.metrics.snapshot()
            if chunk is not None:
                probe_chunked = [srv.generate(p, 32, timeout=600)
                                 for p in probe]
                chunk_ms = _chunk_ms(srv)
        finally:
            srv.stop()
        ttft = srv.ttft_by_class
        res.update(
            deferred=snap.get("deferred", 0),
            shed_predicted=snap.get("shed_predicted", 0),
            shed_brownout=snap.get("shed_brownout", 0),
            shed_deadline=snap.get("shed_deadline", 0),
            shed_queue_full=snap.get("shed_queue_full", 0),
            evicted_mid_decode=snap.get("evicted_mid_decode", 0),
            interactive_ttft_ms_p50=_p(ttft.get("interactive", []), 50),
            interactive_ttft_ms_p99=_p(ttft.get("interactive", []), 99),
            batch_ttft_ms_p99=_p(ttft.get("batch", []), 99),
            completed_by_class={k: len(v) for k, v in ttft.items()},
            chunk_ms=chunk_ms if chunk is not None else None)
        out["overload"][label] = res
        print(f"  overload ({label}, chunked_prefill={chunk}, admission, "
              f"brownout interactive/batch; on/off burst at "
              f"{3 * rate:.1f} requests/s): shed at submit "
              f"{res['shed_at_submit']} (predicted {res['shed_predicted']}, "
              f"brownout {res['shed_brownout']}, queue "
              f"{res['shed_queue_full']}), deferred {res['deferred']}, "
              f"deadline {res['shed_deadline']}; interactive TTFT p50/p99 "
              f"{res['interactive_ttft_ms_p50']}/"
              f"{res['interactive_ttft_ms_p99']} ms, batch p99 "
              f"{res['batch_ttft_ms_p99']} ms; {res['tokens_per_s']} "
              f"tokens/s; one chunk dispatch ({DS_SLOTS} x {DS_CHUNK} rows "
              f"over the {FULL['max_len']}-row window) {res['chunk_ms']} "
              f"ms")

    # 4. fused windows, fixed and paged
    out["fused"] = {}
    for label, kw in (("fixed", dict(slots=DS_SLOTS)), ("paged", DS_PAGED)):
        srv = ContinuousDecodeServer(lm, prompt_buckets=DS_BUCKETS,
                                     fused_serve=DS_K, **kw).start()
        try:
            _warm(srv, DS_K)
            base = srv.metrics.snapshot()
            n_new = 41
            got = srv.generate(probe[0], n_new, timeout=600)
            snap = srv.metrics.snapshot()
            iters = n_new - 1
            fused = {
                "dispatches": _delta(snap, base, "dispatches"),
                "iterations": iters,
                "want_dispatches": math.ceil(iters / DS_K),
                "fused_windows": _delta(snap, base, "fused_windows"),
                "graphs": snap.get("fused_graphs", 0),
                "stream_equals_plain": got[:len(probe[0]) + 32]
                == (probe_paged if kw.get("paged") else probe_fixed)[0]}
            fused.update(_window_vs_steps(srv, DS_SEED))
        finally:
            srv.stop()
        out["fused"][label] = fused
        print(f"  fused_serve={DS_K} ({label}): {fused['dispatches']} "
              f"dispatches for {iters} iterations (ceil: "
              f"{fused['want_dispatches']}), {fused['graphs']} CUDA graph "
              f"captured; window vs {DS_K} plain steps on the same inputs "
              f"(tokens, every cache byte): bit-equal "
              f"{fused['bit_equal']}; {fused['window_ms']:.3f} ms a window "
              f"(graph replay) vs {fused['plain_steps_ms']:.3f} ms for "
              f"{DS_K} plain steps; stream equals the plain server's: "
              f"{fused['stream_equals_plain']}")
        if (fused["dispatches"] != fused["want_dispatches"]
                or fused["graphs"] != 1 or not fused["bit_equal"]):
            raise SystemExit(f"fused windows ({label}) broke a pin")

    # 5. hot swap mid-stream
    lm2 = TransformerLM(**dict(FULL, seed=1), dtype=torch.bfloat16,
                        device="cuda")
    smix = DecodeSizeMix(((1.0, (16, 256), (16, 64)),), vocab=vocab)
    items = build_schedule(PoissonProcess(rate), smix, 24,
                           seed=DS_SEED).items
    srv = ContinuousDecodeServer(lm, slots=DS_SLOTS,
                                 prompt_buckets=DS_BUCKETS).start()
    try:
        _warm(srv)
        before = [srv.submit(list(i["prompt"]), i["max_new"])
                  for i in items[:12]]
        time.sleep(0.05)
        srv.swap(lm2)
        after = [srv.submit(list(i["prompt"]), i["max_new"])
                 for i in items[12:]]
        got = [f.result(600) for f in before + after]
        v1 = [srv.generate(list(i["prompt"]), i["max_new"], timeout=600)
              for i in items]
        srv.swap(lm)
        v0 = [srv.generate(list(i["prompt"]), i["max_new"], timeout=600)
              for i in items]
        failed = srv.metrics.snapshot().get("failed", 0)
    finally:
        srv.stop()
    by_version = [0 if g == a else 1 if g == b else None
                  for g, a, b in zip(got, v0, v1)]
    swap = {"requests": len(items), "failed": failed,
            "served_by_version": {str(v): by_version.count(v)
                                  for v in (0, 1)},
            "unmatched": by_version.count(None),
            "after_swap_on_new": all(v == 1 for v in by_version[12:])}
    out["swap"] = swap
    print(f"  hot swap mid-stream: {len(items)} requests, failed {failed}; "
          f"each stream equals its version's solo stream: served by "
          f"version {swap['served_by_version']}, unmatched "
          f"{swap['unmatched']}")
    if failed or swap["unmatched"] or not swap["after_swap_on_new"]:
        raise SystemExit("the hot swap dropped or mixed a stream")

    # 6. across layouts and shapes: measured, not pinned
    gb = [list(map(int, lm.generate_batch(
        torch.tensor([p], device="cuda"), 32)[0])) for p in probe]
    cross = {}
    for name, other in (("paged_vs_fixed", probe_paged),
                        ("chunked_vs_one_shot", probe_chunked),
                        ("generate_batch_vs_server", gb)):
        pairs = [_first_divergence(a[len(p):], b[len(p):])
                 for a, b, p in zip(other, probe_fixed, probe)]
        cross[name] = {"streams_equal": sum(e for e, _ in pairs),
                       "streams": len(pairs),
                       "first_divergence": [n for _, n in pairs]}
    prefill_err = []
    for p in probe:
        P = len(p)
        padded = torch.zeros(1, DS_BUCKETS[-1], dtype=torch.int64,
                             device="cuda")
        padded[0, :P] = torch.tensor(p)
        a, _ = T.make_paged_prefill_fn(FULL["n_heads"])(
            lm.aux, list(lm.blocks), padded, P)
        h, _ = T.prefill_panels(lm.aux, list(lm.blocks), padded[:, :P],
                                FULL["n_heads"])
        b = T.logits_fn(lm.aux, h[:, -1]).float()
        prefill_err.append(float((a - b).norm() / b.norm()))
    cross["prefill_logits_bucket_vs_exact_rel_err_max"] = max(prefill_err)
    cross["step_logits_paged_vs_fixed_rel_err"] = _step_logits_rel_err(
        lm, probe[0])
    out["cross_shape"] = cross
    print(f"  across layouts and shapes (8 prompts, 32 new tokens; "
          f"measured, not pinned): " + "; ".join(
              f"{k}: {v['streams_equal']}/{v['streams']} equal, first "
              f"divergence {v['first_divergence']}"
              for k, v in cross.items() if isinstance(v, dict))
          + f"; prefill logits bucket 1024 vs exact length, rel. L2 "
          f"{cross['prefill_logits_bucket_vs_exact_rel_err_max']:.3e}; first "
          f"step logits paged (64 slots, 1280 rows) vs fixed (16, 8192) "
          f"{cross['step_logits_paged_vs_fixed_rel_err']:.3e}")

    del lm, lm2
    torch.cuda.empty_cache()
    if any(fa.launches.values()):
        raise SystemExit(f"decode serving launched flash kernels: "
                         f"{fa.launches}")
    out["flash_launches"] = dict(fa.launches)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 22 launched no kernel of the port: {fa.launches}; "
          f"{out['phase_s']:.1f} s")
    return out


# Phase 23: the recurrent path, BASELINE.md configuration #3 (the char-RNN
# as the JAX package's bench.py:342-366 runs it).
CHAR_V, CHAR_B, CHAR_T, CHAR_TBPTT = 77, 64, 200, 50


def _recorded_scores(net):
    """Every optimizer step's score (one per TBPTT segment) of `net`'s
    fits from now on, as tensors (read once, at the end)."""
    scores, step = [], net._train_step

    def recording(loss_fn):
        carries = step(loss_fn)
        scores.append(net._score)
        return carries

    net._train_step = recording
    return scores


def _rel_err(a, b):
    """max |a - b| / (1 + |b|): the absolute error for values below 1, the
    relative one above."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def _three_fits(nets, x, y, t):
    """Three fits of each net on (x, y); every segment's score, per net."""
    scores = [_recorded_scores(n) for n in nets]
    for _ in range(3):
        for n in nets:
            n.fit(x, y)
    want = 3 * -(-t // CHAR_TBPTT)
    for n, sc in zip(nets, scores):
        if len(sc) != want or n.conf.iteration_count != want:
            raise SystemExit(f"{len(sc)} segment scores, iteration_count "
                             f"{n.conf.iteration_count}; want {want}")
    return [[float(v) for v in sc] for sc in scores]


def char_rnn_card_vs_cpu():
    """Phase 23(a). Returns its readings."""
    import numpy as np

    from deeplearning4j_tpu_torch.models.zoo.char_rnn import char_rnn
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        GravesBidirectionalLSTM, SelfAttentionLayer)
    b, t = 8, 120
    print(f"phase 23(a): char-RNN (V={CHAR_V}, 2x200 GravesLSTM, tbptt "
          f"{CHAR_TBPTT}) B={b} T={t}, card vs CPU from the same seeded "
          f"weights: three fits, SGD in f32 and RMSProp in f64")
    rng = np.random.default_rng(23)
    x = np.eye(CHAR_V, dtype=np.float32)[rng.integers(0, CHAR_V, (b, t))]
    y = np.eye(CHAR_V, dtype=np.float32)[rng.integers(0, CHAR_V, (b, t))]
    out = {}
    # f32 with SGD, pinned: scores and parameters 1e-5 as max |card - CPU|
    # / (1 + |CPU|). The configuration's RMSProp at lr 0.1 is chaotic on
    # this random batch (its scores jump several-fold from segment to
    # segment): two runs whose weights differ by 1e-15 (relative) part by
    # orders of magnitude a segment. So in f64 it is measured, not pinned:
    # each segment's score error card vs CPU, beside the CPU's own from
    # weights moved by 1e-15; only the first segment (the same weights on
    # both) is held, to 1e-9.
    nets = [char_rnn(device=d, updater="sgd") for d in ("cuda", "cpu")]
    if not np.array_equal(nets[0].params(), nets[1].params()):
        raise SystemExit("char-RNN weights differ between devices")
    seen = _three_fits(nets, x, y, t)
    res = {"scores": seen[0], "score_err": _rel_err(*seen),
           "param_err": _rel_err(nets[0].params(), nets[1].params())}
    print(f"  sgd_f32: card scores {[round(v, 4) for v in seen[0]]}")
    _check("sgd_f32 segment scores, card vs CPU", res["score_err"], 1e-5)
    _check("sgd_f32 parameters after 3 fits, card vs CPU", res["param_err"],
           1e-5)
    out["sgd_f32"], net = res, nets[0]
    nets = [char_rnn(device=d, data_type="float64")
            for d in ("cuda", "cpu", "cpu")]
    nets[2].set_params(nets[2].params() * (1 + 1e-15))
    seen = _three_fits(nets, x, y, t)
    res = {"scores": seen[0],
           "card_vs_cpu": [_rel_err(a, b) for a, b in zip(*seen[:2])],
           "cpu_perturbed_vs_cpu": [_rel_err(a, b)
                                    for a, b in zip(*seen[1:][::-1])]}
    print(f"  rmsprop_f64: card scores {[round(v, 4) for v in seen[0]]}")
    print(f"  rmsprop_f64 per-segment score error card vs CPU "
          f"{[float(f'{e:.2e}') for e in res['card_vs_cpu']]}; CPU vs CPU "
          f"from weights moved by 1e-15 "
          f"{[float(f'{e:.2e}') for e in res['cpu_perturbed_vs_cpu']]}")
    _check("rmsprop_f64 first segment's score, card vs CPU",
           res["card_vs_cpu"][0], 1e-9)
    out["rmsprop_f64"] = res
    # streaming on the card: 20 single steps against the same 20 steps'
    # output, f32 (1e-5: one step's hoisted projection is a product of
    # another shape)
    full = net.output(x[:, :20])
    net.rnn_clear_previous_state()
    steps = np.stack([net.rnn_time_step(x[:, i]) for i in range(20)], 1)
    out["rnn_time_step_err"] = _max_err(steps, full)
    _check("rnn_time_step x20 vs output, f32 on the card",
           out["rnn_time_step_err"], 1e-5)
    # a GravesBidirectionalLSTM and a causal SelfAttentionLayer forward,
    # f32, with a mask that pads every row: card vs CPU (1e-5: cuBLAS and
    # the CPU sum the 200-wide products in another order; outputs O(1))
    mask = np.ones((b, t), np.float32)
    for i in range(b):
        mask[i, t - 5 * (i + 1):] = 0.0
    xs = np.random.default_rng(24).standard_normal((b, t, 200)).astype(
        np.float32)
    gen = torch.Generator().manual_seed(24)
    for name, layer in (
            ("GravesBidirectionalLSTM",
             GravesBidirectionalLSTM(n_in=200, n_out=200, activation="tanh",
                                     weight_init="xavier")),
            ("SelfAttentionLayer causal",
             SelfAttentionLayer(n_in=200, n_out=200, n_heads=4,
                                causal=True))):
        params = layer.init_params(gen)
        got = []
        for dev in ("cuda", "cpu"):
            with torch.no_grad():
                got.append(layer.forward(
                    {k: v.to(dev) for k, v in params.items()},
                    torch.from_numpy(xs).to(dev),
                    mask=torch.from_numpy(mask).to(dev)).cpu())
        if not bool((got[0][torch.from_numpy(mask) == 0] == 0).all()):
            raise SystemExit(f"{name}: a masked step's output is not 0")
        key = name.split()[0] + "_err"
        out[key] = _max_err(got[0].numpy(), got[1].numpy())
        _check(f"{name} [{b}, {t}, 200] masked forward, card vs CPU",
               out[key], 1e-5)
    return out


def char_rnn_full_width():
    """Phase 23(b). Returns its readings."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.zoo.char_rnn import char_rnn
    warmup, fits = 3, 20
    segments = -(-CHAR_T // CHAR_TBPTT)
    print(f"phase 23(b): char-RNN full width, bf16: V={CHAR_V}, 2x200 "
          f"GravesLSTM, B={CHAR_B}, T={CHAR_T}, tbptt {CHAR_TBPTT} "
          f"({segments} segments), RMSProp lr 0.1; one repeated one-hot "
          f"batch")
    torch.cuda.empty_cache()
    net = char_rnn(data_type="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(23)
    onehot = lambda: torch.nn.functional.one_hot(torch.randint(
        0, CHAR_V, (CHAR_B, CHAR_T), generator=gen, device="cuda"),
        CHAR_V).float()
    ds = DataSet(onehot(), onehot())
    t0 = time.perf_counter()
    warm = []
    for _ in range(warmup):
        net.fit(ds)
        warm.append(net._score)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(fits + 1)]
    scores = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(fits):
        net.fit(ds)
        scores.append(net._score)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    fit_ms = [events[i].elapsed_time(events[i + 1]) for i in range(fits)]
    losses = [float(v) for v in scores]
    mean_ms = sum(fit_ms) / fits
    out = {"fit_ms": fit_ms, "mean_fit_ms": mean_ms,
           "segment_ms": mean_ms / segments,
           "chars_per_s": CHAR_B * CHAR_T * 1e3 / mean_ms,
           "chars_per_s_wall": CHAR_B * CHAR_T * fits / wall_s,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "peak_over_held_gib": (torch.cuda.max_memory_allocated() - held)
           / 2 ** 30,
           "losses": losses, "warmup_losses": [float(v) for v in warm],
           "warmup_s": warm_s, "iteration_count": net.conf.iteration_count}
    print(f"  warm-up losses {[round(v, 3) for v in out['warmup_losses']]} "
          f"({warm_s:.1f} s)")
    print(f"  losses {[round(v, 3) for v in losses]}")
    print(f"  fit ms {[round(v, 2) for v in fit_ms]}; mean {mean_ms:.2f} ms "
          f"a fit, {out['segment_ms']:.2f} ms a segment, "
          f"{out['chars_per_s']:.0f} chars/s ({out['chars_per_s_wall']:.0f} "
          f"by the host clock); peak memory {out['peak_memory_gib']:.3f} GiB "
          f"({out['peak_over_held_gib']:.3f} over what was held before)")
    if (not all(math.isfinite(v) for v in losses)
            or not losses[-1] < losses[0]):
        raise SystemExit(f"char-RNN losses not finite and falling: {losses}")
    if net.conf.iteration_count != (warmup + fits) * segments:
        raise SystemExit(f"iteration_count {net.conf.iteration_count}, want "
                         f"{(warmup + fits) * segments}")
    bad = [n for n, p in net.named_parameters()
           if p.dtype != torch.float32 or not p.is_cuda]
    if bad:
        raise SystemExit(f"parameters not f32 on the card: {bad[:5]}")
    # the host's share: autograd makes tens of thousands of Python objects
    # a fit, so the garbage collector runs often, and each full collection
    # walks the whole heap, which the earlier phases of this process grew.
    # The same fits with the heap's objects frozen out of its reach:
    import gc
    import threading
    out.update(threads=threading.active_count(),
               gc_objects=len(gc.get_objects()))
    gc.collect()
    gc.freeze()
    try:
        frozen = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        frozen[0].record()
        for i in range(5):
            net.fit(ds)
            frozen[i + 1].record()
        torch.cuda.synchronize()
    finally:
        gc.unfreeze()
    out["mean_fit_ms_gc_frozen"] = sum(
        frozen[i].elapsed_time(frozen[i + 1]) for i in range(5)) / 5
    print(f"  {out['gc_objects']} objects on the heap, {out['threads']} "
          f"threads; with them frozen out of the collector's reach: "
          f"{out['mean_fit_ms_gc_frozen']:.2f} ms a fit")
    # where one fit's device time goes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        net.fit(ds)
        torch.cuda.synchronize()
    kernels = sorted(((e.device_time_total, e.count, e.key)
                      for e in prof.key_averages() if e.device_time_total),
                     reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    launches = sum(k[1] for k in kernels)
    out.update(traced_device_ms=busy_ms, device_busy_share=busy_ms / mean_ms,
               launches_per_fit=launches,
               launches_per_segment=launches / segments, by_kind_ms={})
    for us, _, name in kernels:
        kind = _kernel_kind(name)
        out["by_kind_ms"][kind] = out["by_kind_ms"].get(kind, 0.0) + us / 1e3
    out["top_kernels"] = [{"name": k[2][:90], "ms": k[0] / 1e3, "count": k[1]}
                          for k in kernels[:10]]
    print(f"  one traced fit: {busy_ms:.2f} ms of device time in {launches} "
          f"launches ({out['launches_per_segment']:.0f} a segment), "
          f"{out['device_busy_share']:.1%} of the mean fit; by kind: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(
              out["by_kind_ms"].items(), key=lambda kv: -kv[1])))
    print("  the largest:")
    for k in out["top_kernels"]:
        print(f"    {k['ms']:8.3f} ms  x{k['count']:<6d} {k['name']}")
    # the DL4J char example's streaming: a primer, then greedy steps
    primer, n_steps = 50, 200
    x = ds.features[:, :primer].cpu().numpy()
    net.rnn_clear_previous_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = net.rnn_time_step(x)
    primer_ms = 1e3 * (time.perf_counter() - t0)
    eye = np.eye(CHAR_V, dtype=np.float32)
    step = eye[probs[:, -1].argmax(-1)]
    t0 = time.perf_counter()
    for _ in range(n_steps):
        p = net.rnn_time_step(step)
        step = eye[p.argmax(-1)]
    step_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    if (probs.shape != (CHAR_B, primer, CHAR_V) or p.shape != (CHAR_B, CHAR_V)
            or not np.isfinite(p).all()
            or _max_err(p.sum(-1), np.ones(CHAR_B)) > 1e-2):
        raise SystemExit(f"bad rnn_time_step output {p.shape}")
    out.update(primer_ms=primer_ms, rnn_time_step_ms=step_ms)
    print(f"  rnn_time_step: {primer}-char primer at batch {CHAR_B} "
          f"{primer_ms:.2f} ms, then {step_ms:.3f} ms a single greedy step "
          f"(host clock; each step returns numpy)")
    return out


def char_rnn_phase(fa):
    """Phase 23. Returns its readings."""
    t_phase = time.perf_counter()
    fa.reset_launches()
    out = {"card_vs_cpu": char_rnn_card_vs_cpu(),
           "full_width_bf16": char_rnn_full_width()}
    torch.cuda.empty_cache()
    if any(fa.launches.values()):
        raise SystemExit(f"the recurrent path launched flash kernels: "
                         f"{fa.launches}")
    out["flash_launches"] = dict(fa.launches)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 23 launched no kernel of the port: {fa.launches}; "
          f"{out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 24: the embeddings path (BASELINE.md configuration #4)
# ---------------------------------------------------------------------------

EMB_V, EMB_D, EMB_NEG, EMB_WINDOW = 10_000, 100, 5, 5
EMB_SEQ, EMB_SEGMENTS, EMB_PER_SEG, EMB_WARM = 40, 3, 640, 100
EMB_TOL = 1e-5
ANIMALS = ["cat", "dog", "pet", "fur", "tail", "paw", "claw", "kitten",
           "puppy", "whisker", "leash", "collar"]
VEHICLES = ["car", "truck", "road", "wheel", "engine", "tire", "brake",
            "gear", "fuel", "axle", "lane", "horn"]


def _emb_vocab(seed=24):
    """bench.py's config-4 vocabulary: V words with counts zipf(1.5), ranked,
    with Huffman codes."""
    import numpy as np

    from deeplearning4j_tpu_torch.models.word2vec.vocab import (
        VocabCache, build_huffman)
    rng = np.random.default_rng(seed)
    vocab = VocabCache()
    for i in range(EMB_V):
        vocab.add_token(f"w{i}", count=int(rng.zipf(1.5)))
    vocab.finish()
    return build_huffman(vocab)


def _emb_learner(vocab, algo, hs, batch_pairs, device, graph=True):
    from deeplearning4j_tpu_torch.models.embeddings import learning
    from deeplearning4j_tpu_torch.models.embeddings.lookup_table import \
        InMemoryLookupTable
    neg = 0 if hs else EMB_NEG
    table = InMemoryLookupTable(vocab, EMB_D, seed=1, negative=neg,
                                use_hs=hs).reset_weights()
    learner = learning.ELEMENTS_LEARNING[algo](batch_pairs=batch_pairs,
                                               cuda_graph=graph)
    return learner.configure(vocab, table, window=EMB_WINDOW, negative=neg,
                             use_hs=hs, seed=1, device=device)


def _emb_tables(learner):
    return [learner._fetch(learner._syn0), learner._fetch(learner._syn1)]


def _chunk_repeats(idx):
    """Share of 64-row chunks of idx [B, ...] that hold some id twice
    (padding, -1, left out): the flush's chunks are these rows."""
    import numpy as np
    idx = np.asarray(idx)
    chunks = idx.reshape(-1, 64 * int(np.prod(idx.shape[1:])))
    return float(np.mean([len(np.unique(c[c >= 0])) < (c >= 0).sum()
                          for c in chunks]))


def emb_flush_check(vocab, label, algo, hs, batch_pairs, pairs):
    """Phase 24(a): one flush of `pairs` from the same numpy tables on the
    card (graph, its rerun, eager) and on the CPU. Returns its readings."""
    import numpy as np
    repeats = {"rows": _chunk_repeats(pairs[0]),
               "predicted": _chunk_repeats(pairs[1])}
    runs = {}
    for name, device, graph in (("graph", "cuda", True),
                                ("graph_rerun", "cuda", True),
                                ("eager", "cuda", False),
                                ("cpu", "cpu", False)):
        learner = _emb_learner(vocab, algo, hs, batch_pairs, device, graph)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if algo == "skipgram":
            learner.enqueue_pairs(*pairs, 0.025)
        else:
            learner.enqueue_windows(*pairs, 0.025)
        learner._flush(force=True)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        runs[name] = (_emb_tables(learner), ms, learner.flushes)
    T = learner._max_code_len if hs else EMB_NEG + 1
    if not all(repeats.values()):
        raise SystemExit(f"{label}: no chunk repeats an id ({repeats}); the "
                         f"determinism check would be vacuous")
    err = max(_max_err(a, b) for a, b in zip(runs["graph"][0],
                                              runs["cpu"][0]))
    _check(f"{label}: tables, card vs CPU", err, EMB_TOL)
    for other in ("graph_rerun", "eager"):
        for a, b in zip(runs["graph"][0], runs[other][0]):
            if not np.array_equal(a.view(np.uint32), b.view(np.uint32)):
                raise SystemExit(f"{label}: graph and {other} tables differ "
                                 f"({_max_err(a, b):.3e})")
    moved = _max_err(runs["cpu"][0][0], _emb_learner(
        vocab, algo, hs, batch_pairs, "cpu").lookup.syn0)
    print(f"  {label}: graph == its rerun == eager, bit for bit; chunks "
          f"repeating an id: {repeats}; syn0 moved up to {moved:.3e}; "
          f"wall ms (first call, graph capture included): graph "
          f"{runs['graph'][1]:.1f}, rerun {runs['graph_rerun'][1]:.1f}, "
          f"eager {runs['eager'][1]:.1f}, CPU {runs['cpu'][1]:.1f}")
    return {"max_abs_err": err, "chunks_with_repeats": repeats,
            "batch_pairs": batch_pairs, "T": T,
            "flushes": runs["graph"][2], "syn0_moved": moved,
            "wall_ms": {k: v[1] for k, v in runs.items()}}


def emb_glove_check(devices=("cuda", "cuda", "cpu")):
    """Phase 24(a): one GloVe AdaGrad batch of 8,192 co-occurrence entries,
    card (twice) vs CPU, from the same numpy state."""
    import numpy as np

    from deeplearning4j_tpu_torch.common import card_numerics, native_ops
    from deeplearning4j_tpu_torch.models.glove.glove import glove_step
    B = 8192
    rng = np.random.default_rng(26)
    seqs = [(rng.zipf(1.5, EMB_SEQ).clip(1, EMB_V) - 1).tolist()
            for _ in range(400)]
    ci, cj, cx = native_ops.glove_cooc(*native_ops.pack_corpus(seqs),
                                       EMB_WINDOW, True)
    pick = rng.permutation(len(ci))[:B]
    wi, wj, x = ci[pick], cj[pick], cx[pick].astype(np.float64)
    fx = (np.minimum(x / 100.0, 1.0) ** 0.75).astype(np.float32)
    logx = np.log(np.maximum(x, 1e-12)).astype(np.float32)
    init = lambda s: ((rng.random(s) - 0.5) / EMB_D).astype(  # noqa: E731
        np.float32)
    state = {"W": init((EMB_V, EMB_D)), "Wc": init((EMB_V, EMB_D)),
             "b": init((EMB_V,)), "bc": init((EMB_V,))}
    for k in ("W", "Wc", "b", "bc"):
        state["h" + k] = np.abs(init(state[k].shape))
    out = []
    for dev in devices:
        st = {k: torch.tensor(v, device=dev) for k, v in state.items()}
        put = lambda a, dt: torch.as_tensor(  # noqa: E731
            np.asarray(a)).to(dev, dt)
        with card_numerics(torch.device(dev), torch.float32):
            glove_step(st, put(wi, torch.int64), put(wj, torch.int64),
                       put(logx, torch.float32), put(fx, torch.float32),
                       put(np.float32(0.05), torch.float32))
        out.append({k: v.cpu().numpy() for k, v in st.items()})
    err = max(_max_err(out[0][k], out[2][k]) for k in state)
    _check("GloVe batch of 8,192 entries: state, card vs CPU", err, EMB_TOL)
    if not all(np.array_equal(out[0][k], out[1][k]) for k in state):
        raise SystemExit("GloVe: two card runs differ")
    distinct = {"wi": len(set(wi.tolist())), "wj": len(set(wj.tolist()))}
    if max(distinct.values()) == B:
        raise SystemExit("GloVe: no repeated id in the batch; the "
                         "determinism check would be vacuous")
    print(f"  GloVe: two card runs bit-equal; distinct ids in the batch of "
          f"{B}: {distinct}")
    return {"max_abs_err": err, "entries": B, "distinct_ids": distinct}


def emb_card_vs_cpu():
    """Phase 24(a), the steps: card against CPU, and the card's bits."""
    import numpy as np

    from deeplearning4j_tpu_torch.common import native_ops
    print(f"phase 24(a): embeddings flushes, card vs CPU, f32: V={EMB_V} "
          f"(counts zipf(1.5)), D={EMB_D}, window {EMB_WINDOW}")
    vocab = _emb_vocab()
    rng = np.random.default_rng(25)
    seqs = [rng.integers(0, EMB_V, EMB_SEQ).tolist() for _ in range(400)]
    ids, offsets = native_ops.pack_corpus(seqs)
    sg = native_ops.skipgram_pairs(ids, offsets, EMB_WINDOW, 25)
    cbow = native_ops.cbow_contexts(ids, offsets, EMB_WINDOW, 25)
    out = {"max_code_length": max(len(w.codes) for w in vocab.vocab_words())}
    for label, algo, hs, bp, pairs in (
            ("skip-gram, negative 5, 65,536 pairs", "skipgram", False,
             65536, (sg[0][:65536], sg[1][:65536])),
            ("skip-gram, negative 5, 4,096 pairs", "skipgram", False, 4096,
             (sg[0][:4096], sg[1][:4096])),
            (f"skip-gram, hierarchical softmax (T={out['max_code_length']}),"
             f" 4,096 pairs", "skipgram", True, 4096,
             (sg[0][:4096], sg[1][:4096])),
            ("CBOW, negative 5, 4,096 windows", "cbow", False, 4096,
             (cbow[0][:4096], cbow[1][:4096]))):
        key = f"{algo}_{'hs' if hs else 'neg'}_{bp}"
        out[key] = emb_flush_check(vocab, label, algo, hs, bp, pairs)
    out["glove"] = emb_glove_check()
    return out


def _toy_corpus(n_repeat=150, seed=0):
    """The JAX package's tests/test_word2vec.py toy corpus (one vehicle
    word named differently): two topic clusters whose words never co-occur
    across."""
    import numpy as np
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_repeat):
        seqs.append(list(rng.choice(ANIMALS, 6, replace=False)))
        seqs.append(list(rng.choice(VEHICLES, 6, replace=False)))
    return seqs


def _cluster_pin(label, model):
    """The reference's pin (tests/test_word2vec.py:38-43)."""
    intra = model.similarity("cat", "dog")
    inter = model.similarity("cat", "car")
    nearest = [str(w) for w in model.words_nearest("cat", top_n=4)]
    print(f"  {label}: intra {intra:.3f}, inter {inter:.3f}, nearest "
          f"{nearest}")
    if not intra > inter + 0.2 or not set(nearest) <= set(ANIMALS):
        raise SystemExit(f"{label}: cluster pin failed")
    return {"intra": intra, "inter": inter, "nearest": nearest}


def emb_toy_fits(tmp):
    """Phase 24(a), end to end on the card: the reference's toy fits and
    their pins, each round-tripped through the serializer."""
    import numpy as np

    from deeplearning4j_tpu_torch.models import (Glove, ParagraphVectors,
                                                 Word2Vec)
    from deeplearning4j_tpu_torch.models.embeddings import serializer as ws
    from deeplearning4j_tpu_torch.models.embeddings.model_utils import \
        cosine_sim
    print("phase 24(a): toy fits on the card (tests/test_word2vec.py's "
          "corpus and pins), each through the serializer")
    out = {}
    for label, algo, neg, epochs in (("skipgram_hs", "skipgram", 0, 8),
                                     ("skipgram_neg", "skipgram", 5, 8),
                                     ("cbow_neg", "cbow", 5, 10)):
        b = (Word2Vec.Builder().layer_size(24).window_size(3).seed(7)
             .min_word_frequency(1).learning_rate(0.05).epochs(epochs)
             .elements_learning_algorithm(algo))
        b = b.negative_sample(neg) if neg else b.use_hierarchic_softmax(True)
        t0 = time.perf_counter()
        m = b.build().fit(_toy_corpus())
        out[label] = _cluster_pin(f"Word2Vec {label}", m)
        out[label]["fit_s"] = time.perf_counter() - t0
        path = os.path.join(tmp, f"{label}.zip")
        ws.write_full_model(m, path)
        back = ws.read_full_model(path)
        if not np.array_equal(back.lookup.syn0, m.lookup.syn0):
            raise SystemExit(f"{label}: the full-model zip changed syn0")
        _cluster_pin(f"  read back from {os.path.basename(path)}", back)
    docs = [(f"DOC_{i}", t) for i, t in enumerate(_toy_corpus(60))]
    for algo, epochs in (("dbow", 25), ("dm", 6)):
        pv = (ParagraphVectors.Builder().layer_size(24).seed(7)
              .learning_rate(0.05).epochs(epochs).negative_sample(5)
              .sequence_learning_algorithm(algo).build())
        t0 = time.perf_counter()
        pv.fit(docs)
        fit_s = time.perf_counter() - t0
        path = os.path.join(tmp, f"pv_{algo}.zip")
        ws.write_paragraph_vectors(pv, path)
        back = ws.read_paragraph_vectors(path)
        if (back.labels_source.get_labels() != pv.labels_source.get_labels()
                or not np.array_equal(back.lookup.syn0, pv.lookup.syn0)):
            raise SystemExit(f"ParagraphVectors {algo}: the zip differs")
        if algo == "dbow":   # tests/test_word2vec.py:111-124
            va0, va2, vv1 = (pv.get_label_vector(f"DOC_{i}")
                             for i in (0, 2, 1))
            same, other = cosine_sim(va0, va2), cosine_sim(va0, vv1)
            ok = same > other + 0.15
        else:                # :126-136, infer_vector on the restored model
            inferred = back.infer_vector(["cat", "dog", "pet"])
            same = cosine_sim(inferred, back.get_word_vector("fur"))
            other = cosine_sim(inferred, back.get_word_vector("wheel"))
            ok = same > other and inferred.shape == (24,)
        print(f"  ParagraphVectors {algo}: same-cluster {same:.3f}, other "
              f"{other:.3f}; zip round trip equal; {fit_s:.1f} s")
        if not ok:
            raise SystemExit(f"ParagraphVectors {algo}: pin failed")
        out[f"pv_{algo}"] = {"same": same, "other": other, "fit_s": fit_s}
    g = (Glove.Builder().layer_size(24).window_size(3).seed(7)
         .learning_rate(0.1).epochs(25).build())
    t0 = time.perf_counter()
    g.fit(_toy_corpus())
    out["glove"] = _cluster_pin("GloVe", g)
    out["glove"]["fit_s"] = time.perf_counter() - t0
    path = os.path.join(tmp, "glove.txt")
    ws.write_glove_text(g, path)
    err = _max_err(ws.read_word2vec_text(path).lookup.syn0, g.lookup.syn0)
    _check("GloVe text export read back (6 decimals)", err, 1e-5)
    return out


def _emb_segment(learner, chunk, force=True):
    """One segment of bench.py's config 4: the chunk through the native
    corpus route, 256 sequences a call, then a forced flush (with
    force=False the remainder stays queued, so only full flushes run).
    Returns (flushed pairs, seconds)."""
    base = learner._flushed_pairs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(0, len(chunk), 256):
        learner.learn_sequences_batch(chunk[j:j + 256], 0.025)
    learner._flush(force=force)
    torch.cuda.synchronize()
    return learner._flushed_pairs - base, time.perf_counter() - t0


def emb_full_width():
    """Phase 24(b): config 4 as bench.py runs it, graph and eager."""

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.common import native_ops
    print(f"phase 24(b): config 4 at full width: skip-gram, V={EMB_V}, "
          f"D={EMB_D}, negative {EMB_NEG}, window {EMB_WINDOW}, sequences of "
          f"{EMB_SEQ} random ids; native pairs, 256 sequences a call; arms "
          f"65,536 and 4,096 pairs a flush, each as a CUDA graph and eager; "
          f"{EMB_SEGMENTS} interleaved segments of {EMB_PER_SEG} sequences "
          f"after {EMB_WARM}")
    vocab = _emb_vocab()
    rng = np.random.default_rng(27)
    seqs = [rng.integers(0, EMB_V, EMB_SEQ).tolist()
            for _ in range(EMB_WARM + EMB_SEGMENTS * EMB_PER_SEG)]
    arms = {f"batch{bp}_{mode}": _emb_learner(vocab, "skipgram", False, bp,
                                              "cuda", mode == "graph")
            for bp in (65536, 4096) for mode in ("graph", "eager")}
    out = {"native_pairs": native_ops.available(), "arms": {}}
    for name, learner in arms.items():      # warm: capture the graphs
        t0 = time.perf_counter()
        for s in seqs[:EMB_WARM]:
            learner.learn_sequence(s, 0.025)
        learner._flush(force=True)
        torch.cuda.synchronize()
        out["arms"][name] = {"warmup_s": time.perf_counter() - t0,
                             "pairs_per_s": [], "flush_ms": []}
    for i in range(EMB_SEGMENTS):
        chunk = seqs[EMB_WARM + EMB_PER_SEG * i:
                     EMB_WARM + EMB_PER_SEG * (i + 1)]
        for name, learner in arms.items():
            flushes = learner.flushes
            pairs, secs = _emb_segment(learner, chunk)
            arm = out["arms"][name]
            arm["pairs_per_s"].append(pairs / secs)
            arm["flush_ms"].append(1e3 * secs / (learner.flushes - flushes))
            arm["flushes_per_segment"] = learner.flushes - flushes
            arm["pairs_per_segment"] = pairs
    for bp in (65536, 4096):
        g, e = arms[f"batch{bp}_graph"], arms[f"batch{bp}_eager"]
        for a, b in zip(_emb_tables(g), _emb_tables(e)):
            if not np.array_equal(a, b):
                raise SystemExit(f"batch {bp}: graph and eager tables differ "
                                 f"after the segments ({_max_err(a, b)})")
        if not all(np.isfinite(t).all() for t in _emb_tables(g)):
            raise SystemExit(f"batch {bp}: tables not finite")
    print("  after the segments, each arm's graph and eager tables are "
          "bit-equal")
    chunk = seqs[EMB_WARM:EMB_WARM + EMB_PER_SEG]
    for name, learner in arms.items():
        arm = out["arms"][name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        flushes = learner.flushes
        # the first segment's full flushes (2 of 65,536 pairs, 35 of
        # 4,096): the forced padded tail would add a third of the 65,536
        # arms' kernels to the profiler's processing for no new reading
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pairs, secs = _emb_segment(learner, chunk, force=False)
        kernels = [e for e in prof.key_averages() if e.device_time_total]
        busy_ms = sum(e.device_time_total for e in kernels) / 1e3
        n = learner.flushes - flushes
        pps = arm["pairs_per_s"]
        arm.update(
            median_pairs_per_s=statistics.median(pps),
            best_pairs_per_s=max(pps),
            median_flush_ms=statistics.median(arm["flush_ms"]),
            traced_segment_ms=1e3 * secs, traced_device_ms=busy_ms,
            device_ms_per_flush=busy_ms / n,
            device_busy_share=busy_ms / (1e3 * secs),
            kernels_per_flush=sum(e.count for e in kernels) / n,
            host_launches_per_flush=(1 if "graph" in name else
                                     sum(e.count for e in kernels) / n),
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            peak_over_held_gib=(torch.cuda.max_memory_allocated() - held)
            / 2 ** 30,
            top_kernels=[{"name": e.key[:80], "ms": e.device_time_total / 1e3,
                          "count": e.count} for e in sorted(
                              kernels, key=lambda e: -e.device_time_total)[:6]])
        print(f"  {name}: pairs/s median {arm['median_pairs_per_s']:.0f}, "
              f"best {arm['best_pairs_per_s']:.0f} (segments "
              f"{[round(v) for v in pps]}); {arm['median_flush_ms']:.2f} ms a "
              f"flush ({arm['flushes_per_segment']} flushes, "
              f"{arm['pairs_per_segment']} pairs a segment); traced "
              f"segment's {n} full flushes: "
              f"{busy_ms:.1f} ms of device time in {secs * 1e3:.1f} ms "
              f"(busy {arm['device_busy_share']:.1%}), "
              f"{arm['kernels_per_flush']:.0f} kernels a flush; peak "
              f"{arm['peak_memory_gib']:.3f} GiB "
              f"({arm['peak_over_held_gib']:.3f} over what was held)")
        for k in arm["top_kernels"][:3]:
            print(f"      {k['ms']:8.2f} ms x{k['count']:<7d} {k['name']}")
    for bp in (65536, 4096):
        g = out["arms"][f"batch{bp}_graph"]["median_pairs_per_s"]
        e = out["arms"][f"batch{bp}_eager"]["median_pairs_per_s"]
        out[f"graph_over_eager_{bp}"] = g / e
        print(f"  batch {bp}: graph / eager pairs/s (medians) {g / e:.2f}x")
    return out


def emb_sequence_vectors_fit():
    """Phase 24(b): the user's entry point at full width, once:
    `SequenceVectors.fit` (vocab, the native corpus route, one graph a
    flush shape) over 740 sequences of 40 random tokens of V words,
    negative 5, 65,536 pairs a flush."""
    import numpy as np

    from deeplearning4j_tpu_torch.models import SequenceVectors
    rng = np.random.default_rng(28)
    seqs = [[f"w{i}" for i in rng.integers(0, EMB_V, EMB_SEQ)]
            for _ in range(EMB_WARM + EMB_PER_SEG)]
    sv = SequenceVectors(vector_length=EMB_D, window=EMB_WINDOW,
                         negative=EMB_NEG, use_hierarchic_softmax=False,
                         batch_pairs=65536, seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sv.fit(seqs)
    secs = time.perf_counter() - t0
    W = sv.get_word_vector_matrix()
    if W.shape != (len(sv.vocab), EMB_D) or not np.isfinite(W).all():
        raise SystemExit(f"SequenceVectors.fit: bad table {W.shape}")
    print(f"  SequenceVectors.fit at full width (graph capture included): "
          f"{len(sv.vocab)} words, {len(seqs)} sequences, {secs:.2f} s")
    return {"vocab": len(sv.vocab), "sequences": len(seqs), "fit_s": secs}


def embeddings_phase(fa):
    """Phase 24. Returns its readings."""
    import tempfile

    from deeplearning4j_tpu_torch.common import native_ops
    t_phase = time.perf_counter()
    if not native_ops.available():
        raise SystemExit("phase 24 needs the native pair generator: the "
                         "port's loader could not build or load "
                         f"{native_ops.library_path()}")
    print(f"phase 24: the embeddings path; native library "
          f"{native_ops.library_path().name}")
    fa.reset_launches()
    out, part_s = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, part in (("card_vs_cpu", emb_card_vs_cpu),
                          ("toy_fits", partial(emb_toy_fits, tmp)),
                          ("full_width", emb_full_width),
                          ("sequence_vectors_fit", emb_sequence_vectors_fit)):
            t0 = time.perf_counter()
            out[key] = part()
            part_s[key] = time.perf_counter() - t0
            print(f"  ({key}: {part_s[key]:.1f} s)")
    out["part_s"] = part_s
    torch.cuda.empty_cache()
    if any(fa.launches.values()):
        raise SystemExit(f"the embeddings path launched flash kernels: "
                         f"{fa.launches}")
    out["flash_launches"] = dict(fa.launches)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 24 launched no kernel of the port: {fa.launches}; "
          f"{out['phase_s']:.1f} s")
    return out


# Phase 25: data-parallel and parameter-server training, BASELINE.md
# configuration #5 (bench.py:1293-1329: ResNet-50 through ParallelWrapper
# on one device, global batch 128). One card hosts one NCCL rank, so the
# 2-rank runs go through the host over gloo on cuda:0.
PAR_BATCH, PAR_WARM, PAR_TIMED = 128, 2, 10
PS_BATCH, PS_WORKERS, PS_SHORT, PS_LONG = 64, 2, 8, 24
PAR_RANKS = 2        # gloo ranks on cuda:0; over NCCL one per card
PAR_GROUP_TIMEOUT_S, PAR_JOIN_TIMEOUT_S = 60, 240
# 2 ranks against one process, f32, after 4 steps (one k = 4 round): the
# mean of two half-batch gradients against the global batch's, ~1e-8 on
# the CPU. Not longer: a ReLU whose input crosses 0 by a rounding turns
# that into ~1e-5 (LeNet on the CPU: 1.5e-8 for 6 steps, 1.8e-5 after 8).
# The ranks and the one-process run ask for cuDNN's deterministic
# algorithms, which the port then picks by heuristics, alike in every
# process: under cuDNN's timed search each process picks its own, and on
# an H100 that moved LeNet k = 4 by 7.5e-9 to 1.15e-5 from run to run.
# The one-process run is rank 0's own, after the group's.
PAR_TOL = 1e-5


def _par_conv_bn(device, seed=25):
    """The small conv + BatchNorm net of phase 25's pins and (c): 28x28x1,
    conv 8 5x5, BatchNorm, ReLU, 10-way softmax, Nesterov, f32."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater("nesterovs")
            .learning_rate(0.05).list()
            .layer(0, L.ConvolutionLayer(n_out=8, kernel_size=(5, 5),
                                         stride=(2, 2), activation="identity"))
            .layer(1, L.BatchNormalization())
            .layer(2, L.ActivationLayer(activation="relu"))
            .layer(3, L.OutputLayer(n_out=10, activation="softmax",
                                    loss_function="mcxent"))
            .set_input_type(InputType.convolutional(28, 28, 1)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _par_net(kind, device):
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    return (lenet(device=device, data_type="float32") if kind == "lenet"
            else _par_conv_bn(device))


def _par_batches(n, rows, seed):
    """n global batches of 28x28x1 images and one-hot labels (numpy)."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.default_rng(seed)
    return [DataSet(rng.random((rows, 28, 28, 1), dtype=np.float32),
                    _one_hot(rng, rows, 10)) for _ in range(n)]


def par_world1_pins():
    """Phase 25 pins: on one rank the wrapper is plain `fit`, bit for bit,
    in both modes (cuDNN's deterministic algorithms for both runs)."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    batches = _par_batches(8, 32, seed=251)
    out = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for kind in ("lenet", "conv_bn"):
            for k in (1, 4):
                a, b = _par_net(kind, "cuda"), _par_net(kind, "cuda")
                (ParallelWrapper.Builder(a).workers(1).averaging_frequency(k)
                 .build().fit(ListDataSetIterator(batches)))
                for ds in batches:
                    b.fit(ds)
                equal = bool(np.array_equal(a.params(), b.params())
                             and all(torch.equal(s, t) for s, t in zip(
                                 a.buffers(), b.buffers())))
                out[f"{kind}_k{k}"] = equal
                print(f"  one rank, {kind}, averaging frequency {k}: "
                      f"wrapper == plain fit bit for bit: {equal}")
                if not equal:
                    raise SystemExit(f"the one-rank wrapper ({kind}, k={k}) "
                                     f"is not plain fit")
    finally:
        torch.backends.cudnn.deterministic = det
    return out


def par_config5(p17):
    """Phase 25(a): BASELINE config 5 at full width through the wrapper on
    one card, in turns with plain `fit` on the same network. Returns the
    readings and the network."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.zoo.resnet import resnet50
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    print(f"phase 25(a): BASELINE config 5, ResNet-50 bf16, 224x224x3, "
          f"global batch {PAR_BATCH} through ParallelWrapper.workers(1)"
          f".averaging_frequency(1)")
    torch.cuda.empty_cache()
    net = resnet50(data_type="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(25)
    x = torch.rand((PAR_BATCH, 224, 224, 3), generator=gen, device="cuda")
    y = torch.nn.functional.one_hot(torch.randint(
        0, 1000, (PAR_BATCH,), generator=gen, device="cuda"), 1000).float()
    ds = DataSet(x, y)
    pw = (ParallelWrapper.Builder(net).workers(1).averaging_frequency(1)
          .build())
    t0 = time.perf_counter()
    for _ in range(PAR_WARM):
        pw.fit(ds)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    def timed(step, n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        scores = []
        ev[0].record()
        for i in range(n):
            step()
            scores.append(net._score)
            ev[i + 1].record()
        torch.cuda.synchronize()
        return ([ev[i].elapsed_time(ev[i + 1]) for i in range(n)],
                [float(s) for s in scores])

    half = PAR_TIMED // 2
    it0 = net.conf.iteration_count
    w1, l1 = timed(lambda: pw.fit(ds), half)
    p1, _ = timed(lambda: net.fit(ds), half)
    p2, _ = timed(lambda: net.fit(ds), half)
    w2, l2 = timed(lambda: pw.fit(ds), half)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wrap, plain = w1 + w2, p1 + p2
    out = {"wrapper_step_ms": wrap, "plain_step_ms": plain,
           "wrapper_mean_ms": sum(wrap) / len(wrap),
           "plain_mean_ms": sum(plain) / len(plain),
           "warmup_s": warm_s, "peak_memory_gib": peak,
           "losses": l1 + l2, "last_batch_size": net._last_batch_size,
           "iterations": net.conf.iteration_count - it0}
    out["images_per_s"] = PAR_BATCH * 1e3 / out["wrapper_mean_ms"]
    out["plain_images_per_s"] = PAR_BATCH * 1e3 / out["plain_mean_ms"]
    if p17 is not None:
        out["phase17_mean_ms"] = p17["mean_step_ms"]
    print(f"  {PAR_WARM} warm-up fits (cuDNN search) {warm_s:.1f} s; in "
          f"turns (wrapper, plain, plain, wrapper; {half} steps each):")
    print(f"  wrapper {out['wrapper_mean_ms']:.2f} ms a step, "
          f"{out['images_per_s']:.1f} images/s; plain fit "
          f"{out['plain_mean_ms']:.2f} ms, {out['plain_images_per_s']:.1f} "
          f"images/s" + (f"; phase 17 {p17['mean_step_ms']:.2f} ms"
                         if p17 else "") + f"; peak {peak:.2f} GiB")
    print(f"  wrapper losses {[round(l, 4) for l in out['losses']]}")
    if (not all(math.isfinite(l) for l in out["losses"])
            or out["iterations"] != 2 * PAR_TIMED
            or net._last_batch_size != PAR_BATCH):
        raise SystemExit(f"config 5 through the wrapper: bad run {out}")
    return out, net


def par_parameter_server(net):
    """Phase 25(b): ParameterServerParallelWrapper, PS_WORKERS worker
    threads (each on its own stream) on ResNet-50 bf16, PS_BATCH-row
    batches from the card. A first fit of PS_SHORT batches (the worker
    threads' cuDNN search: PyTorch keeps searched plans per thread, and
    the wrapper keeps its threads), then a timed fit of PS_LONG."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import \
        ParameterServerParallelWrapper
    print(f"phase 25(b): ParameterServerParallelWrapper, {PS_WORKERS} "
          f"workers, ResNet-50 bf16, {PS_BATCH}-row batches on the card")
    gen = torch.Generator(device="cuda").manual_seed(252)
    x = torch.rand((PS_LONG * PS_BATCH, 224, 224, 3), generator=gen,
                   device="cuda")
    y = torch.nn.functional.one_hot(torch.randint(
        0, 1000, (PS_LONG * PS_BATCH,), generator=gen, device="cuda"),
        1000).float()
    batches = [DataSet(x[i * PS_BATCH:(i + 1) * PS_BATCH],
                       y[i * PS_BATCH:(i + 1) * PS_BATCH])
               for i in range(PS_LONG)]
    psw = (ParameterServerParallelWrapper.Builder(net).workers(PS_WORKERS)
           .queue_size(8).build())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for label, n in (("first", PS_SHORT), ("timed", PS_LONG)):
        it0 = net.conf.iteration_count
        t0 = time.perf_counter()
        psw.fit(ListDataSetIterator(batches[:n]))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = dict(psw.last_stats)
        if (st["applied"] + st["stale_dropped"] != n
                or net.conf.iteration_count - it0 != st["applied"]
                or not math.isfinite(float(net._score))):
            raise SystemExit(f"parameter server ({label}): {st}")
        out[label] = dict(st, batches=n, seconds=secs,
                          images_per_s=n * PS_BATCH / secs,
                          score=float(net._score))
    # where the time goes: a torch.profiler trace of a fit of PS_SHORT
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        psw.fit(ListDataSetIterator(batches[:PS_SHORT]))
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_time_total]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    out["traced"] = {"batches": PS_SHORT, "seconds": traced_s,
                     "device_ms": busy_ms,
                     "device_busy_share": busy_ms / (traced_s * 1e3),
                     "kernels": sum(e.count for e in kernels)}
    psw.close()
    out["images_per_s"] = out["timed"]["images_per_s"]
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    bad = [n for n, p in net.named_parameters()
           if not torch.isfinite(p).all()]
    if bad:
        raise SystemExit(f"parameter server left non-finite weights: {bad}")
    for label in ("first", "timed"):
        r = out[label]
        print(f"  {label} fit, {r['batches']} batches: {r['seconds']:.2f} s,"
              f" {r['images_per_s']:.1f} images/s; applied {r['applied']}, "
              f"dropped {r['stale_dropped']}, staleness mean "
              f"{r['mean_staleness']:.2f} max {r['max_staleness_seen']}")
    tr = out["traced"]
    print(f"  (the first fit holds the worker threads' cuDNN search); peak "
          f"{out['peak_memory_gib']:.2f} GiB; a traced fit of {PS_SHORT} "
          f"batches: {tr['device_ms']:.1f} ms of device time in "
          f"{tr['seconds'] * 1e3:.1f} ms (busy {tr['device_busy_share']:.1%}"
          f"), {tr['kernels'] / PS_SHORT:.0f} kernels a batch")
    return out


def parallel_rank(rank, world, store, out_dir, backend):
    """One rank of phase 25(c), started by spawn: on cuda:0 in a gloo group,
    or on its own card over NCCL. LeNet and the conv + BatchNorm net
    through the wrapper in all-reduce mode and with k = 4 on this rank's
    rows of the same global batches; rank 0 then runs the same in one
    process; then each net's step timed, its gradient's all-reduce alone,
    and the same step on this rank's rows without the group."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.sharding import (all_reduce_mean,
                                                            make_mesh)
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=PAR_GROUP_TIMEOUT_S))
    torch.backends.cudnn.deterministic = True     # until the timings
    res = {}
    for kind in ("lenet", "conv_bn"):
        for k in (1, 4):
            net = _par_net(kind, "cuda")
            pw = ParallelWrapper.Builder(net).averaging_frequency(k).build()
            pw.fit(ListDataSetIterator(_par_batches(4, 64, seed=253)))
            res[f"{kind}_k{k}"] = {"params": net.params(),
                                   "state": [b.cpu() for b in net.buffers()],
                                   "score": float(net._score),
                                   "iterations": net.conf.iteration_count}
    dist.barrier()
    if rank == 0:           # while the others wait: the same cuDNN plans
        batches = _par_batches(4, 64, seed=253)
        for kind in ("lenet", "conv_bn"):
            for k in (1, 4):
                one = _par_one_process(kind, k, batches, world)
                res[f"{kind}_k{k}"]["one_process"] = {
                    "params": one.params(),
                    "state": [b.cpu() for b in one.buffers()]}
    dist.barrier()
    torch.backends.cudnn.deterministic = False    # the timed search again
    timing = {}
    for kind in ("lenet", "conv_bn"):
        net = _par_net(kind, "cuda")
        pw = ParallelWrapper.Builder(net).build()
        batches = _par_batches(4, 128, seed=254)
        it = ListDataSetIterator(batches)
        pw.fit(it)                                  # warm
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        pw.fit(it, num_epochs=5)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 20
        grads = [torch.randn_like(p) for p in net.parameters()]
        mesh = make_mesh(device="cuda")
        all_reduce_mean(grads, mesh)                # warm
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(20):
            all_reduce_mean(grads + [torch.zeros(1, device="cuda")], mesh)
        torch.cuda.synchronize()
        ar_ms = (time.perf_counter() - t0) * 1e3 / 20
        # the same step without the group: plain fit on this rank's rows
        per = 128 // world
        local = [DataSet(b.features[rank * per:(rank + 1) * per],
                         b.labels[rank * per:(rank + 1) * per])
                 for b in batches]
        for ds in local:
            net.fit(ds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            for ds in local:
                net.fit(ds)
        torch.cuda.synchronize()
        local_ms = (time.perf_counter() - t0) * 1e3 / 20
        timing[kind] = {"step_ms": step_ms, "allreduce_ms": ar_ms,
                        "allreduce_share": ar_ms / step_ms,
                        "local_step_ms": local_ms,
                        "gradient_bytes": 4 * sum(g.numel() for g in grads)}
    res["timing"] = timing
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def _par_spawn(target, args_for, n, timeout_s, label):
    """Start n spawn processes of target(*args_for(i)); wait at most
    timeout_s, kill what is left, fail unless all exit 0."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_for(i)) for i in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * n:
        raise SystemExit(f"{label} exited {codes}")


def _par_one_process(kind, k, batches, n):
    """What n ranks must compute, in this process: all-reduce mode is plain
    `fit` on the global batch; k-step mode is n networks, each taking k
    plain steps on its rows, then their mean (parameters, updater state,
    layer state), round by round."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    if k == 1:
        net = _par_net(kind, "cuda")
        for ds in batches:
            net.fit(ds)
        return net
    nets = [_par_net(kind, "cuda") for _ in range(n)]
    per = batches[0].num_examples() // n
    for r0 in range(0, len(batches), k):
        for r, net in enumerate(nets):
            for ds in batches[r0:r0 + k]:
                net.fit(DataSet(ds.features[r * per:(r + 1) * per],
                                ds.labels[r * per:(r + 1) * per]))
        with torch.no_grad():
            groups = [list(net.parameters()) + list(net.buffers())
                      + [t for key in net._updater_state
                         for st in net._updater_state[key].values()
                         for t in st.values()] for net in nets]
            for same in zip(*groups):
                m = sum(same[1:], same[0].clone()) / n
                for t in same:
                    t.copy_(m)
    return nets[0]


def par_ranks(world, backend):
    """Phase 25(c): `world` ranks against one process; gloo ranks share
    cuda:0 (through the host), NCCL ranks have a card each."""
    where = ("on cuda:0 over gloo (through the host)" if backend == "gloo"
             else "over NCCL, one a card")
    print(f"phase 25(c): {world} ranks {where}: LeNet f32 and conv + "
          f"BatchNorm f32, all-reduce and k = 4, against one process")
    work = (Path(__file__).resolve().parent / "build"
            / f"par_{backend}_{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    _par_spawn(parallel_rank, lambda r: (r, world, str(work / "store"),
                                         str(work), backend),
               world, PAR_JOIN_TIMEOUT_S, f"phase 25(c) {backend} ranks")
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(world)]
    shutil.rmtree(work, ignore_errors=True)
    spawn_s = time.perf_counter() - t0
    out = {"ranks": world, "backend": backend, "spawn_and_run_s": spawn_s}
    batches = _par_batches(4, 64, seed=253)
    for kind in ("lenet", "conv_bn"):
        for k in (1, 4):
            key = f"{kind}_k{k}"
            r0 = ranks[0][key]
            want = r0["one_process"]
            err = _max_err(r0["params"], want["params"])
            state_err = max((_max_err(s, t) for s, t in zip(
                r0["state"], want["state"])), default=0.0)
            torch.backends.cudnn.deterministic = True
            try:
                here = _par_one_process(kind, k, batches, world)
            finally:
                torch.backends.cudnn.deterministic = False
            out[key] = {"max_abs_err": err, "state_err": state_err,
                        "other_process_err": _max_err(r0["params"],
                                                      here.params()),
                        "ranks_equal": all(bool((r0["params"] == r[key][
                            "params"]).all()) for r in ranks),
                        "iterations": r0["iterations"],
                        "score": r0["score"]}
            _check(f"{key}: {world} ranks vs one process (rank 0's), "
                   f"parameters", err, PAR_TOL)
            _check(f"{key}: layer state", state_err, PAR_TOL)
            print(f"  {key}: against one process here (another process, "
                  f"the same heuristics; measured) "
                  f"{out[key]['other_process_err']:.3e}")
            if not out[key]["ranks_equal"] or r0["iterations"] != 4:
                raise SystemExit(f"{key}: ranks differ or bad counters "
                                 f"{out[key]}")
    out["timing"] = [r["timing"] for r in ranks]
    for kind in ("lenet", "conv_bn"):
        t = [r["timing"][kind] for r in ranks]
        print(f"  {kind}, global batch 128, {world} ranks: "
              f"{max(x['step_ms'] for x in t):.2f} ms a step (slowest rank);"
              f" the {backend} all-reduce of its {t[0]['gradient_bytes']} "
              f"gradient bytes alone {max(x['allreduce_ms'] for x in t):.2f}"
              f" ms ({max(x['allreduce_share'] for x in t):.1%} of the "
              f"step); the same step on {128 // world} rows without the "
              f"group {max(x['local_step_ms'] for x in t):.2f} ms")
    print(f"  ({spawn_s:.1f} s with the ranks' start)")
    return out


def ps_worker_main(port, seed):
    """Phase 25(d)'s worker process: ps_worker_fit of LeNet f32 on cuda:0
    against the smoke's PSServer, two epochs of 6 batches of 32."""
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ps_worker_fit
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    ps_worker_fit(_par_net("lenet", "cuda"), "127.0.0.1", port,
                  ListDataSetIterator(_par_batches(6, 32, seed=seed)),
                  num_epochs=2, seed=seed, heartbeat_interval=1.0)


def par_ps_worker_process():
    """Phase 25(d): one ps_worker_fit process against a PSServer here."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import PSServer
    print("phase 25(d): a ps_worker_fit process on cuda:0 against a "
          "PSServer (LeNet f32) in this process")
    net = _par_net("lenet", "cuda")
    ds = DataSet.merge(_par_batches(6, 32, seed=255))   # the worker's data
    s0 = net.score(ds)
    srv = PSServer(net, queue_size=4, n_workers=1, heartbeat_timeout=60.0)
    try:
        _par_spawn(ps_worker_main, lambda _: (srv.port, 255), 1,
                   PAR_JOIN_TIMEOUT_S, "phase 25(d) worker")
        stats = srv.wait(timeout=60)
    finally:
        srv.stop()
    s1 = net.score(ds)
    out = dict(stats, score_before=s0, score_after=s1,
               iterations=net.conf.iteration_count)
    print(f"  server stats {stats}; score {s0:.4f} -> {s1:.4f}")
    if (stats["applied"] + stats["stale_dropped"] != 12
            or stats["workers_done"] != 1 or stats["dup_pushes"]
            or stats["workers_reaped"]
            or net.conf.iteration_count != stats["applied"]
            or not s1 < s0):
        raise SystemExit(f"phase 25(d): the server's stats do not add up "
                         f"{out}")
    return out


def par_training_master():
    """Phase 25(e): TpuDl4jMultiLayer over LeNet, "direct" and "export"."""
    import tempfile

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import (
        ParameterAveragingTrainingMaster, TpuDl4jMultiLayer)
    print("phase 25(e): TpuDl4jMultiLayer over LeNet f32, direct and export")
    batches = _par_batches(6, 64, seed=256)
    data = DataSet.merge(batches)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for approach in ("direct", "export"):
            net = _par_net("lenet", "cuda")
            s0 = net.score(data)
            tm = (ParameterAveragingTrainingMaster.Builder(32)
                  .averaging_frequency(2).collect_training_stats(True)
                  .rdd_training_approach(approach)
                  .export_directory(os.path.join(tmp, "export")).build())
            TpuDl4jMultiLayer(net, tm).fit(data, num_epochs=2)
            s1 = net.score(data)
            phases = sorted({e["phase"] for e in tm.stats.events})
            out[approach] = {"score_before": s0, "score_after": s1,
                             "phases": phases,
                             "iterations": net.conf.iteration_count,
                             "fit_ms": tm.stats.phase_total("fit")}
            print(f"  {approach}: score {s0:.4f} -> {s1:.4f}, phases "
                  f"{phases}, {net.conf.iteration_count} steps")
            want = ["export", "fit"] if approach == "export" else \
                ["fit", "split"]
            if not s1 < s0 or phases != want:
                raise SystemExit(f"phase 25(e) {approach}: {out[approach]}")
    return out


def parallel_phase(fa, p17=None):
    """Phase 25. Returns its readings."""
    t_phase = time.perf_counter()
    print("phase 25: data-parallel and parameter-server training "
          "(BASELINE config 5)")
    fa.reset_launches()
    torch.backends.cudnn.allow_tf32 = False
    out, part_s = {}, {}
    t0 = time.perf_counter()
    out["world1_pins"] = par_world1_pins()
    part_s["world1_pins"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["config5"], net = par_config5(p17)
    part_s["config5"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["parameter_server"] = par_parameter_server(net)
    part_s["parameter_server"] = time.perf_counter() - t0
    del net
    torch.cuda.empty_cache()
    parts = [("two_ranks", partial(par_ranks, PAR_RANKS, "gloo"))]
    if torch.cuda.device_count() >= 2:
        parts.append(("nccl_ranks", partial(par_ranks,
                                            torch.cuda.device_count(),
                                            "nccl")))
    parts += [("ps_worker_process", par_ps_worker_process),
              ("training_master", par_training_master)]
    for key, part in parts:
        t0 = time.perf_counter()
        out[key] = part()
        part_s[key] = time.perf_counter() - t0
    out["part_s"] = part_s
    if any(fa.launches.values()):
        raise SystemExit(f"the parallel path launched flash kernels: "
                         f"{fa.launches}")
    out["flash_launches"] = dict(fa.launches)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  parts (s): " + ", ".join(f"{k} {v:.1f}"
                                       for k, v in part_s.items()))
    print(f"  phase 25 launched no kernel of the port: {fa.launches}; "
          f"{out['phase_s']:.1f} s")
    return out



# ---------------------------------------------------------------------------
# Phase 26: fused steps and the training-health watchdog (configs 1 and 3)
# ---------------------------------------------------------------------------

FUSED_K = 8
LENET_B, LENET_BATCHES, LENET_SEGMENTS = 512, 16, 5
CHAR_FITS, CHAR_BLOCK = 20, 5


def _record_steps(net):
    """Every optimizer step's score of `net` from now on, in order: the
    single steps' scores and each fused group's [K] scores (tensors, read
    at the end)."""
    seen = []
    step, replay = net._train_step, net._replay

    def recording_step(loss_fn, reduce=None):
        carries = step(loss_fn, reduce)
        seen.append(net._score.reshape(1))
        return carries

    def recording_replay(grp, values, g):
        out = replay(grp, values, g)
        seen.append(out[0])
        return out

    net._train_step, net._replay = recording_step, recording_replay
    return seen


def _step_scores(seen):
    return torch.cat([s.float().reshape(-1) for s in seen]).cpu().tolist() \
        if seen else []


def _same_training_state(label, a, b, scores_a=None, scores_b=None):
    """Fail unless `a` and `b` hold bit-equal f32 masters, updater and
    layer state, iteration counts and (when given) step scores."""
    import numpy as np
    bad = []
    if not np.array_equal(a.params(), b.params()):
        bad.append(f"parameters (max diff "
                   f"{_max_err(a.params(), b.params()):.3e})")
    for key, _ in a._keyed_layers():
        for k, st in a._updater_state[key].items():
            for n, t in st.items():
                if not torch.equal(t, b._updater_state[key][k][n]):
                    bad.append(f"updater state {key}.{k}.{n}")
        for n, t in a._slot(key).state().items():
            if not torch.equal(t, b._slot(key).state()[n]):
                bad.append(f"layer state {key}.{n}")
    if a.conf.iteration_count != b.conf.iteration_count:
        bad.append(f"iteration_count {a.conf.iteration_count} vs "
                   f"{b.conf.iteration_count}")
    if scores_a is not None and _step_scores(scores_a) != \
            _step_scores(scores_b):
        bad.append("step scores")
    if bad:
        raise SystemExit(f"{label}: not bit-equal: {bad[:6]}")
    print(f"  {label}: bit-equal (parameters, updater and layer state, "
          f"{a.conf.iteration_count} iterations"
          + (f", {len(_step_scores(scores_a))} step scores"
             if scores_a is not None else "") + ")")


def _small_net(device, seed=7, updater="adam", lr=0.01, policy=None,
               dropout=None, mse=False, data_type="float32"):
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                        OutputLayer)
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    b = (NeuralNetConfiguration.Builder().seed(seed).updater(updater)
         .learning_rate(lr).data_type(data_type))
    if policy == "exponential":
        b = b.learning_rate_decay_policy("exponential").lr_policy_decay_rate(
            0.9)
    elif policy == "schedule":
        b = b.learning_rate_decay_policy("schedule").learning_rate_schedule(
            {0: 0.05, 5: 0.02, 11: 0.005})
    if dropout is not None:
        b = b.dropout(dropout)
    act, loss = ("identity", "mse") if mse else ("softmax", "mcxent")
    conf = (b.list()
            .layer(0, DenseLayer(n_out=32, activation="identity" if mse
                                 else "relu"))
            .layer(1, DenseLayer(n_out=16, activation="identity" if mse
                                 else "tanh"))
            .layer(2, OutputLayer(n_out=3, activation=act,
                                  loss_function=loss))
            .set_input_type(InputType.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _small_batches(n_batches, seed, rows=16):
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    r = np.random.default_rng(seed)
    x = r.random((n_batches * rows, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.argmax(x @ r.random((5, 3)), 1)]
    return list(DataSet(x, y).batch_by(rows))


def _poisoned(batches, call, poison):
    from deeplearning4j_tpu_torch.common.resilience import FaultInjector
    from deeplearning4j_tpu_torch.datasets.iterators import (
        DataSetValidator, ListDataSetIterator, ValidatingDataSetIterator)
    inj = FaultInjector(seed=0)
    inj.plan("data.batch", on_call=call, corrupt=poison)
    v = DataSetValidator(policy="count", check_finite=False,
                         fault_injector=inj)
    return ValidatingDataSetIterator(ListDataSetIterator(batches), v)


def _lenet_f32_card_vs_cpu():
    """Phase 26(c)'s f32 LeNet, fused groups card vs CPU (phase 15's
    reasons: cuDNN and the CPU sum the windows and the products in other
    orders), on phase 15's batch, pinned at 1e-5: a group of 3 (phase 15's
    three steps) and a group of 8 on the parameters and every inner step's
    score; the group of 8 bit-equal to 8 single steps on the card. Measured:
    8 fresh batches, beside the CPU against itself from one weight moved by
    1e-7, which a 2x2 max-pool window with two near-equal inputs turns into
    another pick and a ~0.5% change of the conv kernels' gradients (1.191e-4
    after 8 steps). Under cuDNN's deterministic algorithms the card read
    2.235e-8 throughout on an H100; under its timed search (in the same
    process the f32 algorithms may differ from run to run) 8 steps read
    8.0e-6 to 1.349e-5 on phase 15's batch and 1.191e-4 on the fresh ones,
    so all of it runs under the deterministic algorithms."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    out = {}
    rng = np.random.default_rng(15)
    x, y = rng.random((64, 784), dtype=np.float32), _one_hot(rng, 64, 10)
    for k in (3, FUSED_K):
        nets = {(dev, kk): lenet(device=dev, data_type="float32")
                .fused_steps(kk) for dev in ("cuda", "cpu")
                for kk in ((1, k) if k == FUSED_K else (k,))}
        seen = {key: _record_steps(n) for key, n in nets.items()}
        for n in nets.values():
            n.fit(ListDataSetIterator([DataSet(x, y)] * k))
        if nets["cuda", k].fused_counts["graph_replays"] != 1:
            raise SystemExit(f"f32 LeNet: {nets['cuda', k].fused_counts}")
        params = _max_err(nets["cuda", k].params(), nets["cpu", k].params())
        if k == 3:
            out["lenet_f32_group3_params"] = params
            _check("f32 LeNet, a fused group of 3 (phase 15's steps): card "
                   "vs CPU parameters", params, 1e-5)
            continue
        out["lenet_f32_group8_scores"] = _max_err(
            _step_scores(seen["cuda", k]), _step_scores(seen["cpu", k]))
        _check("f32 LeNet, a fused group of 8: card vs CPU, every step's "
               "score", out["lenet_f32_group8_scores"], 1e-5)
        out["lenet_f32_group8_params"] = params
        _check("f32 LeNet, a fused group of 8: card vs CPU parameters",
               params, 1e-5)
        _same_training_state("f32 LeNet, a fused group of 8 vs 8 single "
                             "steps on the card", nets["cuda", 1],
                             nets["cuda", k], seen["cuda", 1],
                             seen["cuda", k])
    rng = np.random.default_rng(26)
    xs = rng.random((FUSED_K * 64, 784), dtype=np.float32)
    batches = list(DataSet(xs, _one_hot(rng, FUSED_K * 64, 10)).batch_by(64))
    nets = {dev: lenet(device=dev, data_type="float32").fused_steps(FUSED_K)
            for dev in ("cuda", "cpu")}
    moved = nets["cpu"].params()
    moved[0] += 1e-7
    nets["moved"] = lenet(device="cpu", data_type="float32").fused_steps(
        FUSED_K)
    nets["moved"].set_params(moved)
    for n in nets.values():
        n.fit(ListDataSetIterator(batches))
    out["lenet_f32_fresh_batches"] = {
        "card_vs_cpu": _max_err(nets["cuda"].params(), nets["cpu"].params()),
        "cpu_vs_cpu_moved_1e-7": _max_err(nets["moved"].params(),
                                          nets["cpu"].params())}
    print(f"  f32 LeNet fused8, 8 fresh batches of 64 (measured): card vs "
          f"CPU {out['lenet_f32_fresh_batches']['card_vs_cpu']:.3e}; the CPU "
          f"against itself from one weight moved by 1e-7 "
          f"{out['lenet_f32_fresh_batches']['cpu_vs_cpu_moved_1e-7']:.3e}")
    return out


def fused_pins():
    """Phase 26(c): fused8 == fused1 on small nets on the card (lr
    schedules over two groups, dropout, a first group from a fresh net, a
    TBPTT group at t0 != 0), and f32 LeNet fused8 card vs CPU."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo.char_rnn import char_rnn
    print("phase 26(c): fused steps == single steps on small nets on the "
          "card")
    out = {}
    cases = {"lr exponential, two groups": dict(policy="exponential"),
             "lr schedule map, two groups": dict(policy="schedule",
                                                 updater="nesterovs"),
             "dropout 0.7": dict(dropout=0.7, updater="sgd", lr=0.1)}
    for label, kw in cases.items():
        batches = _small_batches(2 * FUSED_K, seed=len(label))
        a, b = (_small_net("cuda", **kw) for _ in range(2))
        b.fused_steps(FUSED_K)
        sa, sb = _record_steps(a), _record_steps(b)
        for n in (a, b):
            n.fit(ListDataSetIterator(batches))
        if b.fused_counts["graph_replays"] != 2:
            raise SystemExit(f"{label}: {b.fused_counts}")
        _same_training_state(label, a, b, sa, sb)
    # the first group from a fresh net, alone
    batches = _small_batches(FUSED_K, seed=3)
    a, b = _small_net("cuda", dropout=0.8), _small_net("cuda", dropout=0.8)
    b.fused_steps(FUSED_K)
    sa, sb = _record_steps(a), _record_steps(b)
    for n in (a, b):
        n.fit(ListDataSetIterator(batches))
    _same_training_state("first group from a fresh net (dropout 0.8)", a, b,
                         sa, sb)
    # TBPTT: T=20, L=4, K=2: groups at t0 = 0 and 8 (one capture), the tail
    # segment at 16 single-step; two fits
    r = np.random.default_rng(26)
    x = np.eye(11, dtype=np.float32)[r.integers(0, 11, (4, 20))]
    y = np.eye(11, dtype=np.float32)[r.integers(0, 11, (4, 20))]
    kw = dict(vocab_size=11, hidden=16, tbptt_length=4)
    a, b = char_rnn(**kw), char_rnn(**kw).fused_steps(2)
    sa, sb = _record_steps(a), _record_steps(b)
    for _ in range(2):
        for n in (a, b):
            n.fit(DataSet(x, y))
    c = b.fused_counts
    if (c["captures"], c["graph_replays"]) != (1, 4):
        raise SystemExit(f"TBPTT t0 != 0: {c}")
    _same_training_state("TBPTT groups at t0 = 0 and 8 (one capture), tail "
                         "single-step", a, b, sa, sb)
    out["tbptt_counts"] = dict(c)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out.update(_lenet_f32_card_vs_cpu())
    finally:
        torch.backends.cudnn.deterministic = det
    return out


def _trace_fit(fit):
    """(device ms, kernels, wall ms) of one call of `fit`, traced."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_time_total
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    return {"device_ms": busy_ms, "kernels": sum(e.count for e in kernels),
            "wall_ms": wall_ms, "busy_share": busy_ms / wall_ms}


def fused_lenet():
    """Phase 26(a): BASELINE config 1 as bench.py:178-224 runs it. Returns
    its readings."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    print(f"phase 26(a): LeNet bf16, batch {LENET_B}, {LENET_BATCHES} "
          f"batches a fit from a ListDataSetIterator: fused_steps"
          f"({FUSED_K}) against fused1, {LENET_SEGMENTS} interleaved "
          f"segments an arm")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(261)
    x = torch.rand((LENET_B, 784), generator=gen, device="cuda")
    y = torch.nn.functional.one_hot(torch.randint(
        0, 10, (LENET_B,), generator=gen, device="cuda"), 10).float()
    ds = DataSet(x, y)
    nets = {"fused1": lenet(data_type="bfloat16"),
            "fused8": lenet(data_type="bfloat16").fused_steps(FUSED_K)}
    seen = {k: _record_steps(n) for k, n in nets.items()}
    out = {k: {"images_per_s": [], "peak_gib": None} for k in nets}

    def segment(name):
        net = nets[name]
        before = net.fused_counts["graph_replays"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        net.fit(ListDataSetIterator([ds] * LENET_BATCHES))
        float(net._score)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out[name]["peak_over_held_gib"] = max(
            out[name].get("peak_over_held_gib", 0.0),
            (torch.cuda.max_memory_allocated() - held) / 2 ** 30)
        replays = net.fused_counts["graph_replays"] - before
        want = LENET_BATCHES // FUSED_K if name == "fused8" else 0
        if replays != want:
            raise SystemExit(f"{name}: {replays} graph replays a fit, want "
                             f"{want}: {net.fused_counts}")
        return LENET_B * LENET_BATCHES / dt, dt

    t0 = time.perf_counter()
    for name in nets:                 # warm-up: cuDNN's search, the capture
        out[name]["first_fit_s"] = segment(name)[1]
    for i in range(LENET_SEGMENTS):
        order = list(nets) if i % 2 == 0 else list(nets)[::-1]
        for name in order:
            ips, _ = segment(name)
            out[name]["images_per_s"].append(ips)
            out[name]["peak_gib"] = max(
                out[name]["peak_gib"] or 0.0,
                torch.cuda.max_memory_allocated() / 2 ** 30)
    for name in nets:
        v = sorted(out[name]["images_per_s"])
        out[name]["median_images_per_s"] = v[len(v) // 2]
        print(f"  {name}: first fit {out[name]['first_fit_s']:.2f} s; "
              f"images/s {[round(a) for a in out[name]['images_per_s']]}, "
              f"median {out[name]['median_images_per_s']:.0f}; peak "
              f"{out[name]['peak_gib']:.3f} GiB, "
              f"{out[name]['peak_over_held_gib']:.3f} over what was held")
    out["fused8_over_fused1"] = (out["fused8"]["median_images_per_s"]
                                 / out["fused1"]["median_images_per_s"])
    _same_training_state(f"LeNet bf16 fused8 vs fused1 after "
                         f"{LENET_SEGMENTS + 1} fits", nets["fused1"],
                         nets["fused8"], seen["fused1"], seen["fused8"])
    losses = _step_scores(seen["fused8"])
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"LeNet losses not finite: {losses[:8]}")
    out["fused_counts"] = dict(nets["fused8"].fused_counts)
    out["first_last_loss"] = [losses[0], losses[-1]]
    # one group (8 steps) against one eager step, traced
    out["trace_group"] = _trace_fit(lambda: nets["fused8"].fit(
        ListDataSetIterator([ds] * FUSED_K)))
    out["trace_step"] = _trace_fit(lambda: nets["fused1"].fit(
        ListDataSetIterator([ds])))
    for k, name, steps in (("trace_group", "fused8", FUSED_K),
                           ("trace_step", "fused1", 1)):
        t = out[k]
        step_ms = LENET_B * 1e3 / out[name]["median_images_per_s"]
        out[name]["busy_share_timed"] = t["device_ms"] / steps / step_ms
        print(f"  {k}: {t['kernels']} kernels, {t['device_ms']:.3f} ms of "
              f"device time in {t['wall_ms']:.3f} ms traced, busy "
              f"{t['busy_share']:.1%}; {out[name]['busy_share_timed']:.1%} "
              f"of a median timed step ({step_ms:.3f} ms)")
    out["phase_s"] = time.perf_counter() - t0
    return out


def fused_char_rnn():
    """Phase 26(b): BASELINE config 3 as bench.py:342-416 runs it. Returns
    its readings."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.zoo.char_rnn import char_rnn
    segments = CHAR_T // CHAR_TBPTT
    print(f"phase 26(b): char-RNN bf16 V={CHAR_V}, 2x200 GravesLSTM, "
          f"B={CHAR_B}, T={CHAR_T}, tbptt {CHAR_TBPTT} ({segments} "
          f"segments): fused_steps({FUSED_K}) against fused1, {CHAR_FITS} "
          f"timed fits an arm in blocks of {CHAR_BLOCK}, interleaved")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(262)
    onehot = lambda: torch.nn.functional.one_hot(torch.randint(  # noqa: E731
        0, CHAR_V, (CHAR_B, CHAR_T), generator=gen, device="cuda"),
        CHAR_V).float()
    ds = DataSet(onehot(), onehot())
    nets = {"fused1": char_rnn(data_type="bfloat16"),
            "fused8": char_rnn(data_type="bfloat16").fused_steps(FUSED_K)}
    seen = {k: _record_steps(n) for k, n in nets.items()}
    out = {k: {"block_chars_per_s": []} for k in nets}
    t0 = time.perf_counter()
    for name, net in nets.items():    # warm-up; fused8 captures here
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        out[name]["first_fit_s"] = time.perf_counter() - t1
    for i in range(CHAR_FITS // CHAR_BLOCK):
        order = list(nets) if i % 2 == 0 else list(nets)[::-1]
        for name in order:
            net = nets[name]
            before = net.fused_counts["graph_replays"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t1 = time.perf_counter()
            for _ in range(CHAR_BLOCK):
                net.fit(ds)
            float(net._score)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            out[name]["peak_over_held_gib"] = max(
                out[name].get("peak_over_held_gib", 0.0),
                (torch.cuda.max_memory_allocated() - held) / 2 ** 30)
            replays = net.fused_counts["graph_replays"] - before
            want = CHAR_BLOCK if name == "fused8" else 0
            if replays != want:
                raise SystemExit(f"char-RNN {name}: {replays} replays in "
                                 f"{CHAR_BLOCK} fits, want {want}")
            out[name]["block_chars_per_s"].append(
                CHAR_B * CHAR_T * CHAR_BLOCK / dt)
            out[name]["peak_gib"] = max(
                out[name].get("peak_gib", 0.0),
                torch.cuda.max_memory_allocated() / 2 ** 30)
    for name in nets:
        v = out[name]["block_chars_per_s"]
        out[name]["chars_per_s"] = len(v) / sum(1.0 / c for c in v)
        out[name]["ms_per_fit"] = CHAR_B * CHAR_T * 1e3 / out[name][
            "chars_per_s"]
        print(f"  {name}: first fit {out[name]['first_fit_s']:.2f} s; "
              f"chars/s by block {[round(c) for c in v]}, over the "
              f"{CHAR_FITS} fits {out[name]['chars_per_s']:.0f} "
              f"({out[name]['ms_per_fit']:.2f} ms a fit); peak "
              f"{out[name]['peak_gib']:.3f} GiB, "
              f"{out[name]['peak_over_held_gib']:.3f} over what was held")
    out["fused8_over_fused1"] = (out["fused8"]["chars_per_s"]
                                 / out["fused1"]["chars_per_s"])
    _same_training_state(f"char-RNN bf16 fused8 vs fused1 after "
                         f"{CHAR_FITS + 1} fits", nets["fused1"],
                         nets["fused8"], seen["fused1"], seen["fused8"])
    losses = _step_scores(seen["fused8"])
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"char-RNN losses not finite: {losses[:8]}")
    out["fused_counts"] = dict(nets["fused8"].fused_counts)
    out["first_last_loss"] = [losses[0], losses[-1]]
    out["trace_fused8_fit"] = _trace_fit(lambda: nets["fused8"].fit(ds))
    out["trace_fused1_fit"] = _trace_fit(lambda: nets["fused1"].fit(ds))
    for k, name in (("trace_fused8_fit", "fused8"),
                    ("trace_fused1_fit", "fused1")):
        t = out[k]
        out[name]["busy_share_timed"] = (t["device_ms"]
                                         / out[name]["ms_per_fit"])
        print(f"  {k}: {t['kernels']} kernels, {t['device_ms']:.3f} ms of "
              f"device time in {t['wall_ms']:.3f} ms traced, busy "
              f"{t['busy_share']:.1%}; {out[name]['busy_share_timed']:.1%} "
              f"of the timed fit's {out[name]['ms_per_fit']:.2f} ms")
    out["phase_s"] = time.perf_counter() - t0
    return out


def fused_health():
    """Phase 26(d): the watchdog on the card. Returns its readings."""
    import tempfile

    from deeplearning4j_tpu_torch.common.health import (
        TrainingDivergedError, TrainingHealthPolicy)
    from deeplearning4j_tpu_torch.common.resilience import FaultInjector
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    print("phase 26(d): the training-health watchdog on the card")
    out = {}
    # a NaN batch at inner step 3 of a group of 8
    batches = _small_batches(2 * FUSED_K, seed=264)
    pols = [TrainingHealthPolicy(max_consecutive_bad=5) for _ in range(2)]
    a = _small_net("cuda", seed=11).training_health(pols[0])
    b = _small_net("cuda", seed=11).fused_steps(FUSED_K).training_health(
        pols[1])
    for n in (a, b):
        n.fit(_poisoned(batches, 3, "nan"))
    if pols[0].counts != pols[1].counts or pols[1].counts["skips"] != 1:
        raise SystemExit(f"NaN skip counts {pols[0].counts} vs "
                         f"{pols[1].counts}")
    if b.fused_counts["graph_replays"] != 2:
        raise SystemExit(f"NaN skip: {b.fused_counts}")
    _same_training_state("NaN at inner step 3 of 8: fused8 vs the "
                         "sequential run that skips it", a, b)
    out["nan_skip_counts"] = dict(pols[1].counts)
    # a finite divergence rolls back mid-group through the checkpoints
    tmp = tempfile.mkdtemp(prefix="dl4j_phase26_", dir=os.getcwd()
                           if os.access(os.getcwd(), os.W_OK) else None)
    try:
        batches = _small_batches(8, seed=265)
        pol = TrainingHealthPolicy(grad_norm_limit=50.0,
                                   max_consecutive_bad=4)
        net = _small_net("cuda", seed=4, mse=True).fused_steps(
            FUSED_K).training_health(pol, checkpoint_dir=f"{tmp}/fit",
                                     checkpoint_every=4)
        net.fit(_poisoned(batches, 5, 200.0))
        rb = [e for e in pol.events if e["kind"] == "rollback"]
        ref = _small_net("cuda", seed=4, mse=True)
        ref.fit(ListDataSetIterator(batches[:4] + batches[6:]))
        replayed = net.fused_counts["single_steps"].get("rollback_replay")
        if (pol.counts["rollbacks"], rb[0]["restoredRound"] if rb else None,
                net.conf.iteration_count, replayed) != (1, 4, 6, 2):
            raise SystemExit(f"fit-loop rollback: {pol.counts} {rb} "
                             f"{net.conf.iteration_count}")
        _same_training_state("divergence at inner step 1 of a group of 4: "
                             "restored round 4, the 2 batches left "
                             "replayed, == the run without batches 4-5",
                             net, ref)
        out["fit_rollback"] = {"restored_round": rb[0]["restoredRound"],
                               "iteration_count": net.conf.iteration_count,
                               "counts": dict(pol.counts),
                               "fused_counts": dict(net.fused_counts)}
        # N consecutive bad steps abort, naming the rounds
        pol = TrainingHealthPolicy(max_consecutive_bad=2)
        net = _small_net("cuda", seed=6).fused_steps(FUSED_K) \
            .training_health(pol)
        net.fit(ListDataSetIterator(_small_batches(2, seed=266)))
        bad = DataSet(torch.full((16, 5), float("nan")),
                      torch.eye(3)[torch.zeros(16, dtype=torch.long)])
        try:
            net.fit(ListDataSetIterator([bad] * FUSED_K))
        except TrainingDivergedError as e:
            out["abort_message"] = str(e)
        else:
            raise SystemExit("consecutive NaN steps did not abort")
        if "offending rounds [2, 3]" not in out["abort_message"]:
            raise SystemExit(f"abort message: {out['abort_message']}")
        print(f"  abort: {out['abort_message']}")
        # ParallelWrapper on one rank, both modes: the reference's
        # test_training_health.py:308 contract (restored round 5,
        # iteration_count 7 in all-reduce mode) and bit-equality with the
        # run that never saw the poisoned batch (k = 2: its round)
        out["wrapper"] = {}
        for k in (1, 2):
            batches = _small_batches(8, seed=267)
            inj = FaultInjector(seed=0)
            inj.plan("wrapper.batch", on_call=5, corrupt=200.0)
            pol = TrainingHealthPolicy(grad_norm_limit=50.0,
                                       max_consecutive_bad=4)
            net = _small_net("cuda", seed=5, mse=True)
            (ParallelWrapper.Builder(net).averaging_frequency(k)
             .checkpointing(f"{tmp}/pw{k}").fault_injector(inj)
             .health_policy(pol).build().fit(ListDataSetIterator(batches)))
            ref = _small_net("cuda", seed=5, mse=True)
            kept = (batches[:5] + batches[6:] if k == 1
                    else batches[:4] + batches[6:])
            (ParallelWrapper.Builder(ref).averaging_frequency(k).build()
             .fit(ListDataSetIterator(kept)))
            rb = [e for e in pol.events if e["kind"] == "rollback"]
            want = (5, 7) if k == 1 else (2, 6)
            got = (rb[0]["restoredRound"] if rb else None,
                   net.conf.iteration_count)
            if got != want or pol.counts["rollbacks"] != 1:
                raise SystemExit(f"wrapper k={k}: {got} want {want}, "
                                 f"{pol.counts}")
            _same_training_state(f"ParallelWrapper k={k}: restored round "
                                 f"{got[0]}, iteration_count {got[1]}, == "
                                 f"the run without the poisoned round",
                                 net, ref)
            out["wrapper"][f"k{k}"] = {"restored_round": got[0],
                                       "iteration_count": got[1]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def fused_phase(fa):
    """Phase 26. Returns its readings."""
    t_phase = time.perf_counter()
    fa.reset_launches()
    out = {"pins": fused_pins(), "health": fused_health(),
           "lenet": fused_lenet(), "char_rnn": fused_char_rnn()}
    torch.cuda.empty_cache()
    if any(fa.launches.values()):
        raise SystemExit(f"the fused path launched flash kernels: "
                         f"{fa.launches}")
    out["flash_launches"] = dict(fa.launches)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 26 launched no kernel of the port: {fa.launches}; "
          f"{out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 27: ResNet-50 with segment remat, speculation and durable KV state
# ---------------------------------------------------------------------------
REMAT_B, REMAT_SEGMENTS, REMAT_STEPS = 128, 4, 4
SPEC_K, SPEC_REQUESTS, SPEC_NEW = 4, 64, (16, 140)
SPEC_TEACH_STEPS, SPEC_TEACH_T, SPEC_TEACH_LR = 150, 128, 0.05
# Phase 27(c) preemption, tools/serve_ab.py's shape at full width: two
# batch requests (9-token prompt, 312 new: 320 rows, 20 blocks of 16)
# reserve the 40-block pool whole, a third keeps it full; 8 interactive
# requests of 4 tokens a segment, each with PREEMPT_SLO_MS to finish
PREEMPT_BLOCKS, PREEMPT_NEW, PREEMPT_SLO_MS = 40, 312, 100.0
PREEMPT_SEGMENTS, PREEMPT_INTERACTIVE = 2, 8


def _remat_pins():
    """Phase 27(a) pins: remat == plain on phase 16's 64x64 ResNet-50 at
    batch 2 in f32 under cuDNN's deterministic algorithms (2 steps: scores
    rtol 1e-5, parameters 2e-5, the reference's bounds), and remat with
    fused_steps(2) == two single remat steps, bit for bit (a CUDA graph of
    two steps whose backward recomputes the segments)."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo.resnet import resnet50
    kw = dict(height=64, width=64, num_classes=10, data_type="float32")
    rng = np.random.default_rng(27)
    batches = [DataSet(rng.random((2, 64, 64, 3), dtype=np.float32),
                       _one_hot(rng, 2, 10)) for _ in range(4)]
    out = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        nets = [resnet50(device="cuda", remat=r, **kw) for r in (False, True)]
        scores = [[], []]
        for i, net in enumerate(nets):
            for ds in batches[:2]:
                net.fit(ds)
                scores[i].append(float(net._score))
        score_rel = max(abs(a - b) / abs(a) for a, b in zip(*scores))
        param_err = _max_err(nets[0].params(), nets[1].params())
        out["f32_two_steps"] = {"scores": scores, "score_rel": score_rel,
                                "param_max_abs": param_err}
        print(f"  f32 64x64 batch 2, 2 steps, remat vs plain: scores "
              f"{scores[1]} vs {scores[0]} (rel {score_rel:.3e}, limit "
              f"1e-5), parameters {param_err:.3e} (limit 2e-5)")
        if score_rel > 1e-5 or param_err > 2e-5:
            raise SystemExit("remat and plain ResNet-50 disagree")
        single = resnet50(device="cuda", remat=True, **kw)
        fused = resnet50(device="cuda", remat=True, **kw).fused_steps(2)
        for net in (single, fused):
            net.fit(ListDataSetIterator(batches))
        same = bool(np.array_equal(single.params(), fused.params())
                    and float(single._score) == float(fused._score))
        out["fused2_equals_single"] = same
        out["fused2_counts"] = dict(fused.fused_counts)
        print(f"  remat, fused_steps(2) over 4 batches == 4 single remat "
              f"steps, bit for bit: {same} ({fused.fused_counts})")
        if not same or fused.fused_counts["graph_replays"] != 2:
            raise SystemExit("remat fused group differs from single steps")
        # the dropout keep masks under a captured recompute: the reference
        # test's residual graph with input dropout, plain vs remat fused
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        conf = _dropout_residual_conf()
        toy = [DataSet(rng.random((8, 8, 8, 2), dtype=np.float32),
                       _one_hot(rng, 8, 3)) for _ in range(4)]
        a = ComputationGraph(conf, device="cuda").init()
        b = ComputationGraph(conf, remat_segments=True,
                             device="cuda").init().fused_steps(2)
        for net in (a, b):
            net.fit(ListDataSetIterator(toy))
        same = bool(np.array_equal(a.params(), b.params()))
        out["dropout_remat_fused_equals_plain"] = same
        print(f"  residual graph, dropout 0.7: remat fused2 == plain single "
              f"steps, bit for bit: {same}")
        if not same:
            raise SystemExit("dropout under a captured remat differs")
    finally:
        torch.backends.cudnn.deterministic = det
    return out


def _dropout_residual_conf():
    """tests/test_remat_segments.py's two-block residual graph, its
    convolutions with input dropout 0.7."""
    from deeplearning4j_tpu_torch.nn.conf.graph_vertices import \
        ElementWiseVertex
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer,
                                                         BatchNormalization,
                                                         ConvolutionLayer,
                                                         GlobalPoolingLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    gb = (NeuralNetConfiguration.Builder().seed(7).updater("sgd")
          .learning_rate(0.1).weight_init("relu").graph_builder()
          .add_inputs("input"))
    conv = lambda: ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                    convolution_mode="same", dropout=0.7)
    gb.add_layer("c0", ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                        convolution_mode="same"), "input")
    x = "c0"
    for b in range(2):
        gb.add_layer(f"b{b}_c1", conv(), x)
        gb.add_layer(f"b{b}_bn", BatchNormalization(), f"b{b}_c1")
        gb.add_layer(f"b{b}_r", ActivationLayer(activation="relu"),
                     f"b{b}_bn")
        gb.add_layer(f"b{b}_c2", conv(), f"b{b}_r")
        gb.add_vertex(f"b{b}_add", ElementWiseVertex(op="add"), f"b{b}_c2",
                      x)
        gb.add_layer(f"b{b}_out", ActivationLayer(activation="relu"),
                     f"b{b}_add")
        x = f"b{b}_out"
    gb.add_layer("pool", GlobalPoolingLayer(pooling_type="avg"), x)
    gb.add_layer("fc", OutputLayer(n_out=3, activation="softmax",
                                   loss_function="mcxent"), "pool")
    return (gb.set_outputs("fc")
            .set_input_types(InputType.convolutional(8, 8, 2)).build())


def _timed_fit(net, ds):
    """(ms by CUDA events, peak bytes over what was held before) of one
    fit step."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    net.fit(ds)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), torch.cuda.max_memory_allocated() - held


def remat_phase():
    """Phase 27(a). Returns its readings."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.zoo.resnet import resnet50
    print("phase 27(a): ResNet-50 with segment remat (BASELINE config 2, "
          "bench.py's resnet50_remat)")
    out = {"pins": _remat_pins()}
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(27)
    x = torch.rand((REMAT_B, 224, 224, 3), generator=gen, device="cuda")
    y = torch.nn.functional.one_hot(
        torch.randint(0, 1000, (REMAT_B,), generator=gen, device="cuda"),
        1000).float()
    ds = DataSet(x, y)
    # two steps from the same weights, twice. Under cuDNN's deterministic
    # algorithms the remat arm's parameters are held to one bf16 rounding
    # (2^-8) of the largest parameter change of the plain arm. Under the
    # timed search (the speed runs' mode) the search may pick algorithms
    # that are not deterministic, so two plain nets part too: measured,
    # beside that plain-vs-plain control
    det = torch.backends.cudnn.deterministic
    two = {}
    try:
        for mode in ("deterministic", "timed_search"):
            torch.backends.cudnn.deterministic = mode == "deterministic"
            nets = {"plain": resnet50(data_type="bfloat16"),
                    "remat": resnet50(data_type="bfloat16", remat=True)}
            if mode == "timed_search":
                nets["plain_again"] = resnet50(data_type="bfloat16")
            start = nets["plain"].params()
            for net in nets.values():
                for _ in range(2):
                    net.fit(ds)
            after = {n: net.params() for n, net in nets.items()}
            change = after["plain"] - start
            norm = float(np.linalg.norm(change))
            rel = lambda other: float(np.linalg.norm(
                after[other] - after["plain"]) / norm)
            two[mode] = {
                "param_max_abs": _max_err(after["plain"], after["remat"]),
                "limit": 2.0 ** -8 * float(np.abs(change).max()),
                "rel_l2_of_change": rel("remat")}
            if mode == "timed_search":
                two[mode]["control_plain_vs_plain_rel_l2"] = rel(
                    "plain_again")
                arms = {"plain": nets["plain"], "remat": nets["remat"]}
            del nets, start, after, change
            print(f"  bf16 batch {REMAT_B}, 2 steps from the same weights, "
                  f"{mode}: largest parameter difference remat vs plain "
                  f"{two[mode]['param_max_abs']:.3e} (limit "
                  f"{two[mode]['limit']:.3e} = 2^-8 x the largest parameter "
                  f"change); relative L2 of the difference over the change "
                  f"{two[mode]['rel_l2_of_change']:.3e}" + (
                      f"; control, two plain nets: "
                      f"{two[mode]['control_plain_vs_plain_rel_l2']:.3e}"
                      if mode == "timed_search" else ""))
    finally:
        torch.backends.cudnn.deterministic = det
    out["bf16_two_steps"] = two
    if two["deterministic"]["param_max_abs"] > two["deterministic"]["limit"]:
        raise SystemExit("remat and plain bf16 ResNet-50 drift apart under "
                         "the deterministic algorithms")
    ms = {n: [] for n in arms}
    peak = {n: [] for n in arms}
    losses = {n: [] for n in arms}
    for _ in range(REMAT_SEGMENTS):
        for name, net in arms.items():
            for _ in range(REMAT_STEPS):
                t, p = _timed_fit(net, ds)
                ms[name].append(t)
                peak[name].append(p)
                losses[name].append(float(net._score))
    for name, net in arms.items():
        med = sorted(ms[name])[len(ms[name]) // 2]
        out[name] = {
            "ms_per_step_median": med, "ms_per_step": ms[name],
            "images_per_s": REMAT_B / (med / 1e3),
            "peak_over_held_bytes": max(peak[name]),
            "losses_finite": bool(np.isfinite(losses[name]).all()),
            "trace": _kernel_breakdown(lambda: net.fit(ds), iters=1, top=4)}
        print(f"  {name}: {med:.2f} ms a step (median of "
              f"{len(ms[name])}, interleaved), "
              f"{out[name]['images_per_s']:.1f} images/s, peak "
              f"{max(peak[name]) / 2**30:.2f} GiB over what was held; "
              f"traced step: {out[name]['trace']}")
        if not out[name]["losses_finite"]:
            raise SystemExit(f"{name}: a loss is not finite")
    out["remat_over_plain_ms"] = (out["remat"]["ms_per_step_median"]
                                  / out["plain"]["ms_per_step_median"])
    out["remat_over_plain_peak"] = (out["remat"]["peak_over_held_bytes"]
                                    / out["plain"]["peak_over_held_bytes"])
    del arms, ds, x, y
    torch.cuda.empty_cache()
    return out


class _CyclicMix:
    """bench.py's speculative workload (bench.py:754-762): a 2-4 token
    pattern repeated, 6-15 prompt tokens, 16-139 new tokens."""

    def __init__(self, vocab):
        self.vocab = vocab

    def sample(self, rng):
        pat = [rng.randrange(1, self.vocab)
               for _ in range(rng.randrange(2, 5))]
        return {"prompt": tuple((pat * 8)[:rng.randrange(6, 16)]),
                "max_new": rng.randrange(*SPEC_NEW)}


def _teach_cycles(lm, steps, t):
    """bench.py:743-752: a few SGD steps on short cyclic sequences (the
    flash kernels' training path). Returns (first, last) loss."""
    import numpy as np
    r = np.random.default_rng(0)
    V = lm.aux.tok.shape[0]
    losses = []
    for _ in range(steps):
        xs = []
        for _ in range(16):
            pat = r.integers(1, V, int(r.integers(2, 5))).tolist()
            xs.append((pat * (t // len(pat) + 2))[:t + 1])
        xs = np.asarray(xs)
        losses.append(lm.fit_batch(xs[:, :-1], xs[:, 1:]))
    torch.cuda.synchronize()
    if not all(math.isfinite(l) for l in losses):
        raise SystemExit(f"teaching diverged: {losses[-5:]}")
    return losses[0], losses[-1]


def _verify_ms(srv):
    """Device ms of one verify dispatch of `srv` at its full slot width
    (every slot computed, none active, so nothing is written) by CUDA
    events, and its kernels from a trace."""
    aux, blocks = srv.current_params()
    S, K = srv.slots, srv._spec.k
    idle = torch.zeros(S, dtype=torch.bool, device="cuda")
    toks = torch.zeros(S, K, dtype=torch.int64, device="cuda")
    if srv.paged:
        btabs = torch.as_tensor(srv._btabs, device="cuda")
        wto = torch.zeros(S, dtype=torch.int64, device="cuda")
        step = lambda: srv._verify(aux, blocks, srv._cache, btabs, srv._pos,
                                   toks, idle, wto)
    else:
        step = lambda: srv._verify(aux, blocks, srv._cache, srv._pos, toks,
                                   idle)
    return cuda_ms(step, iters=20, warmup=3), _kernel_breakdown(step)


def _spec_readings(srv, sched):
    """run_load readings of `srv` on `sched` with its speculation metrics,
    and its streams keyed by schedule item."""
    base = srv.metrics.snapshot()
    res, streams = _serve_load(srv, sched)
    snap = srv.metrics.snapshot()
    res.update(
        accepted_per_dispatch=snap.get("spec_accepted_per_dispatch_mean"),
        acceptance_rate=snap.get("spec_acceptance_rate_mean"),
        draft_dispatches=_delta(snap, base, "draft_dispatches"),
        device_dispatches_per_token=(
            (_delta(snap, base, "dispatches")
             + _delta(snap, base, "draft_dispatches"))
            / max(1, _delta(snap, base, "tokens_out"))))
    return res, {id(item): toks for item, toks in streams}


def _share_equal(a, b):
    keys = [k for k in a if k in b]
    return sum(a[k] == b[k] for k in keys) / len(keys) if keys else None


def speculation_phase(fa):
    """Phase 27(b). Returns its readings. The teaching steps run the flash
    training kernels: their launches are recorded, then the counters are
    set to 0 before the servers run."""
    from deeplearning4j_tpu_torch.models.zoo.transformer import TransformerLM
    from deeplearning4j_tpu_torch.serving import (ClosedLoop,
                                                  ContinuousDecodeServer,
                                                  ModelDraft, NGramDraft,
                                                  Speculator, build_schedule)
    print(f"phase 27(b): speculative decoding at full width (phase 22's "
          f"model, bf16), Speculator(NGramDraft(n=3), k={SPEC_K}) against "
          f"the plain server on one schedule of cyclic prompts")
    # bench.py teaches at lr 0.3 in f32; in bf16 at full width that
    # diverged to NaN on the card, and 0.1 rose on the CPU: 0.05
    lm = TransformerLM(**FULL, dtype=torch.bfloat16, device="cuda",
                       learning_rate=SPEC_TEACH_LR)
    out = {"teach_loss_first_last": _teach_cycles(lm, SPEC_TEACH_STEPS,
                                                  SPEC_TEACH_T),
           "teach_launches": dict(fa.launches)}
    fa.reset_launches()
    print(f"  taught {SPEC_TEACH_STEPS} fit_batch steps of 16 x "
          f"{SPEC_TEACH_T} cyclic tokens (lr {SPEC_TEACH_LR}): loss "
          f"{out['teach_loss_first_last']}")
    mix = _CyclicMix(FULL["vocab_size"])
    sched = build_schedule(ClosedLoop(DS_SLOTS), mix, SPEC_REQUESTS,
                           seed=DS_SEED + 5)
    layouts = {"fixed": dict(slots=DS_SLOTS), "paged": DS_PAGED}
    spec_streams = {}
    for layout, kw in layouts.items():
        res = {}
        streams = {}
        for arm in ("speculative", "plain"):
            spec = (Speculator(NGramDraft(n=3), k=SPEC_K)
                    if arm == "speculative" else None)
            srv = ContinuousDecodeServer(lm, prompt_buckets=DS_BUCKETS,
                                         max_queue=SPEC_REQUESTS,
                                         speculate=spec, **kw).start()
            try:
                _warm(srv)
                res[arm], streams[arm] = _spec_readings(srv, sched)
                if spec is not None:
                    res[arm]["verify_ms"], res[arm]["verify_trace"] = \
                        _verify_ms(srv)
                    # join == solo inside the speculative server
                    items = sched.items[:8]
                    solo = [srv.generate(list(it["prompt"]), it["max_new"],
                                         timeout=600) for it in items]
                    res[arm]["join_equals_solo"] = all(
                        s == streams[arm][id(it)]
                        for s, it in zip(solo, items))
                if srv.paged:
                    res[arm]["pool_check"] = bool(srv._pool.check())
                    res[arm]["blocks_in_use_after"] = \
                        srv._pool.blocks_in_use
            finally:
                srv.stop()
        sp, pl = res["speculative"], res["plain"]
        sp["streams_equal_plain_share"] = _share_equal(
            streams["speculative"], streams["plain"])
        spec_streams[layout] = streams["speculative"]
        out[layout] = res
        print(f"  {layout}: speculative {sp['tokens_per_s']} tokens/s, "
              f"{sp['dispatches_per_token']:.4f} dispatches/token, "
              f"{sp['accepted_per_dispatch']:.3f} accepted a slot-dispatch "
              f"(acceptance {sp['acceptance_rate']:.3f}), TTFT p50/p99 "
              f"{sp['ttft_ms_p50']}/{sp['ttft_ms_p99']} ms, inter-token "
              f"p50/p99 {sp['inter_token_ms_p50']}/"
              f"{sp['inter_token_ms_p99']} ms; plain {pl['tokens_per_s']} "
              f"tokens/s, {pl['dispatches_per_token']:.4f} dispatches/token,"
              f" TTFT p50/p99 {pl['ttft_ms_p50']}/{pl['ttft_ms_p99']} ms, "
              f"inter-token p50/p99 {pl['inter_token_ms_p50']}/"
              f"{pl['inter_token_ms_p99']} ms")
        print(f"  {layout}: verify dispatch {sp['verify_ms']:.3f} ms (CUDA "
              f"events), traced {sp['verify_trace']}; join == solo "
              f"{sp['join_equals_solo']}; streams equal to the plain "
              f"server's (measured): {sp['streams_equal_plain_share']}")
        if not sp["join_equals_solo"]:
            raise SystemExit(f"{layout}: a speculative co-batched stream "
                             f"differs from its solo run")
        if sp["failed"] or pl["failed"]:
            raise SystemExit(f"{layout}: requests failed")
        for arm in res.values():
            if layout == "paged" and (not arm["pool_check"]
                                      or arm["blocks_in_use_after"]):
                raise SystemExit(f"{layout}: the block pool leaked")
    out["paged_equals_fixed_share"] = _share_equal(spec_streams["fixed"],
                                                   spec_streams["paged"])
    print(f"  speculative paged == speculative fixed (other slot counts, "
          f"measured): {out['paged_equals_fixed_share']}")
    # the model drafting for itself (a ModelDraft pays its own dispatches)
    msched = build_schedule(ClosedLoop(4), mix, 8, seed=DS_SEED + 6)
    srv = ContinuousDecodeServer(
        lm, slots=4, prompt_buckets=(64,), max_queue=8,
        speculate=Speculator(ModelDraft(lm), k=SPEC_K)).start()
    try:
        _warm(srv)
        md, _ = _spec_readings(srv, msched)
    finally:
        srv.stop()
    out["model_draft"] = md
    print(f"  ModelDraft (the model drafting for itself), 4 slots, 8 "
          f"requests: {md['tokens_per_s']} tokens/s, "
          f"{md['accepted_per_dispatch']:.3f} accepted a slot-dispatch, "
          f"{md['dispatches_per_token']:.4f} verify dispatches/token, "
          f"{md['device_dispatches_per_token']:.3f} with the draft's")
    if md["failed"]:
        raise SystemExit("ModelDraft requests failed")
    del lm
    torch.cuda.empty_cache()
    return out


def _timed_durable(srv, timing):
    """Time the preempting server's extract (the gather), spill (gather,
    copy to the host, artifact) and install, each ended by a
    synchronize."""
    extract, artifact, install = (srv._extract, srv._extract_artifact,
                                  srv._install_panel)

    def timed(fn, key):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            timing[key].append((time.perf_counter() - t0) * 1e3)
            return r
        return run
    srv._extract = timed(extract, "extract_ms")
    srv._extract_artifact = timed(artifact, "spill_ms")
    srv._install_panel = timed(install, "install_ms")


def _preempt_ab(lm):
    """Phase 27(c) preemption against shed-only (tools/serve_ab.py's
    bench_preempt_ab at full width). Returns its readings."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import (BrownoutPolicy,
                                                  ContinuousDecodeServer)
    V = FULL["vocab_size"]
    timing = {"extract_ms": [], "spill_ms": [], "install_ms": []}

    def mk(preempt):
        srv = ContinuousDecodeServer(
            lm, slots=4, prompt_buckets=(64,), max_queue=256, paged=True,
            block_size=16, n_blocks=PREEMPT_BLOCKS, max_blocks_per_slot=80,
            brownout=BrownoutPolicy(classes={"batch": (0.9, 1.01)}),
            preempt=preempt).start()
        # warm-up through the server's own thread, the preempt arm's
        # extract and install included: a pool-filling batch pair and one
        # interactive request
        srv.generate([1, 2, 3, 4], 4, timeout=600)
        warm = [srv.submit(list(range(1, 10)), PREEMPT_NEW, klass="batch")
                for _ in range(2)]
        time.sleep(0.05)
        try:
            srv.generate([5, 6, 7], 4, deadline_ms=10_000, timeout=600)
        except Exception:           # noqa: BLE001 - the shed arm may miss
            pass
        for f in warm:
            f.result(600)
        return srv

    servers = {"preempt": mk(True), "shed_only": mk(False)}
    _timed_durable(servers["preempt"], timing)
    for v in timing.values():
        v.clear()
    base = {n: s.metrics.snapshot() for n, s in servers.items()}
    good = {n: [] for n in servers}
    inter_ms = {n: [] for n in servers}
    kept = []       # (prompt, stream) of the preempt arm's batch requests
    for seg in range(PREEMPT_SEGMENTS):
        for name, srv in servers.items():
            rng = np.random.default_rng(300 + seg)
            t0 = time.perf_counter()
            batch = [(p, srv.submit(p, PREEMPT_NEW, klass="batch"))
                     for p in (rng.integers(1, V, 9).tolist()
                               for _ in range(3))]
            time.sleep(0.05)            # let them admit and occupy
            inter = []
            for _ in range(PREEMPT_INTERACTIVE):
                p = rng.integers(1, V, int(rng.integers(3, 8))).tolist()
                t_sub = time.perf_counter()
                try:
                    f = srv.submit(p, 4, deadline_ms=PREEMPT_SLO_MS,
                                   klass="interactive")
                except Exception:       # noqa: BLE001 - shed: a miss
                    f = None
                inter.append((f, t_sub))
                time.sleep(0.004)
            tokens = 0
            for f, t_sub in inter:
                if f is None:
                    continue
                try:
                    f.result(600)
                except Exception:       # noqa: BLE001 - shed or evicted
                    continue
                ms = (time.perf_counter() - t_sub) * 1e3
                inter_ms[name].append(ms)
                tokens += 4 if ms <= PREEMPT_SLO_MS else 0
            for p, f in batch:
                s = f.result(600)
                if name == "preempt":
                    kept.append((p, s))
            good[name].append(tokens / (time.perf_counter() - t0))
    out = {}
    for name, srv in servers.items():
        snap = srv.metrics.snapshot()
        out[name] = {
            "interactive_goodput_tokens_per_s": good[name],
            "interactive_goodput_median": sorted(good[name])[
                len(good[name]) // 2],
            "interactive_completed": len(inter_ms[name]),
            "interactive_completion_ms_p50": _p(inter_ms[name], 50),
            "interactive_completion_ms_p99": _p(inter_ms[name], 99),
            "preempted": _delta(snap, base[name], "preempted"),
            "resumed": _delta(snap, base[name], "resumed"),
            "spill_bytes": _delta(snap, base[name], "spill_bytes"),
            "shed_deadline": _delta(snap, base[name], "shed_deadline"),
            "blocked_on_memory": _delta(snap, base[name],
                                        "blocked_on_memory")}
    pre = servers["preempt"]
    # a preempted-and-resumed stream == the same request served alone by
    # the same server (its programs and shapes)
    solo = [pre.generate(p, PREEMPT_NEW, timeout=600) for p, _ in kept]
    out["resumed_equal_solo"] = all(a == s for a, (_, s) in zip(solo, kept))
    for srv in servers.values():
        srv.stop(timeout=120)
    out["pool_check"] = all(bool(s._pool.check()) for s in servers.values())
    out["blocks_in_use_after"] = sum(s._pool.blocks_in_use
                                     for s in servers.values())
    n = len(timing["spill_ms"])
    out["per_preemption_ms"] = {
        "extract": _p(timing["extract_ms"][:n], 50),
        "copy": _p([s - e for s, e in zip(timing["spill_ms"],
                                          timing["extract_ms"])], 50),
        "install": _p(timing["install_ms"], 50), "preemptions": n,
        "installs": len(timing["install_ms"])}
    p, s = out["preempt"], out["shed_only"]
    print(f"  preemption ({PREEMPT_BLOCKS} blocks of 16, 4 slots; batch 9+"
          f"{PREEMPT_NEW} tokens, interactive 4 tokens in "
          f"{PREEMPT_SLO_MS:g} ms): interactive goodput (tokens/s in "
          f"deadline, median of {PREEMPT_SEGMENTS}) preempt "
          f"{p['interactive_goodput_median']:.1f} vs shed-only "
          f"{s['interactive_goodput_median']:.1f}; completion p50/p99 "
          f"{p['interactive_completion_ms_p50']}/"
          f"{p['interactive_completion_ms_p99']} vs "
          f"{s['interactive_completion_ms_p50']}/"
          f"{s['interactive_completion_ms_p99']} ms; preempted "
          f"{p['preempted']}, resumed {p['resumed']}, spill "
          f"{p['spill_bytes']} bytes")
    print(f"  per preemption (median ms, synchronized): "
          f"{out['per_preemption_ms']}; resumed streams == solo "
          f"{out['resumed_equal_solo']} ({len(kept)} batch streams); pool "
          f"check {out['pool_check']}, blocks in use after "
          f"{out['blocks_in_use_after']}")
    if not out["resumed_equal_solo"]:
        raise SystemExit("a preempted stream differs from its solo run")
    if not out["pool_check"] or out["blocks_in_use_after"]:
        raise SystemExit("the block pool leaked")
    if not p["preempted"] or not p["resumed"]:
        raise SystemExit("the preempt arm never preempted")
    return out


def _migration(lm):
    """Phase 27(c) migration: two DS_PAGED servers on one card."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import (ContinuousDecodeServer,
                                                  RequestMigratedError)
    rng = np.random.default_rng(27)
    prompt = rng.integers(1, FULL["vocab_size"], 100).tolist()
    n_new = 200
    a = ContinuousDecodeServer(lm, prompt_buckets=DS_BUCKETS,
                               **DS_PAGED).start()
    b = ContinuousDecodeServer(lm, prompt_buckets=DS_BUCKETS,
                               **DS_PAGED).start()
    try:
        for srv in (a, b):
            _warm(srv)
        ref = a.generate(prompt, n_new, timeout=600)
        fut = a.submit(prompt, n_new)
        t0 = time.monotonic()
        while not any(r is not None and r.future is fut
                      and r.pf_next is None and len(r.generated) >= 40
                      for r in a._slot_req):
            if time.monotonic() - t0 > 60:
                raise SystemExit("the request never reached decode")
            time.sleep(0.0005)
        t0 = time.perf_counter()
        art = a.migrate_out(fut)
        out_ms = (time.perf_counter() - t0) * 1e3
        try:
            fut.result(10)
            raise SystemExit("the migrated request's source future resolved")
        except RequestMigratedError:
            pass
        got = b.migrate_in(art).result(600)
        tags = (a._version_tag(0), b._version_tag(0))
    finally:
        a.stop()
        b.stop()
    out = {"equal_solo": got == ref, "tags_equal": tags[0] == tags[1],
           "tag": tags[0], "artifact_bytes": art.nbytes,
           "artifact_dtype": str(art.panels[0][0].dtype),
           "generated_at_export": len(art.generated),
           "migrate_out_ms": out_ms}
    print(f"  migration: {len(art.generated)} tokens decoded on A, "
          f"artifact {art.nbytes} bytes ({out['artifact_dtype']}), "
          f"migrate_out {out_ms:.2f} ms; stream on B == A's solo "
          f"{out['equal_solo']}; fingerprints equal {out['tags_equal']} "
          f"({tags[0]})")
    if not out["equal_solo"] or not out["tags_equal"]:
        raise SystemExit("the migrated stream or the fingerprints differ")
    return out


def _prefix_on_disk(lm):
    """Phase 27(c) the prefix cache on disk: save, restore in a new
    server, hit and equal streams."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import ContinuousDecodeServer
    from deeplearning4j_tpu_torch.serving.kvstate import PrefixCacheArtifact

    class Timed(ContinuousDecodeServer):
        def restore_prefix_cache(self, path=None):
            t0 = time.perf_counter()
            n = super().restore_prefix_cache(path)
            torch.cuda.synchronize()
            self.restore_ms = (time.perf_counter() - t0) * 1e3
            self.restored_blocks = n
            return n

    rng = np.random.default_rng(270)
    V = FULL["vocab_size"]
    systems = [rng.integers(1, V, 16 * int(rng.integers(16, 33))).tolist()
               for _ in range(4)]
    work = [(systems[i % 4] + rng.integers(1, V, 20).tolist(), 24)
            for i in range(8)]
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    pdir = root / f"spec_kv_prefix_{os.getpid()}"
    shutil.rmtree(pdir, ignore_errors=True)
    try:
        s1 = ContinuousDecodeServer(lm, prompt_buckets=DS_BUCKETS,
                                    **DS_PAGED).start()
        try:
            _warm(s1)
            first = [s1.generate(p, n, timeout=600) for p, n in work]
        finally:
            s1.stop()
        t0 = time.perf_counter()
        s1.save_prefix_cache(str(pdir))
        save_ms = (time.perf_counter() - t0) * 1e3
        written = sum(f.stat().st_size for f in pdir.iterdir())
        art = PrefixCacheArtifact.load(str(pdir))
        s2 = Timed(lm, prompt_buckets=DS_BUCKETS, prefix_cache_dir=str(pdir),
                   **DS_PAGED).start()
        try:
            _warm(s2)
            again = [s2.generate(p, n, timeout=600) for p, n in work]
            snap = s2.metrics.snapshot()
        finally:
            s2.stop()                   # saves the cache again, at stop()
    finally:
        shutil.rmtree(pdir, ignore_errors=True)
    out = {"blocks_saved": len(art.entries), "bytes_written": written,
           "artifact_dtype": str(art.entries[0][1][0][0].dtype),
           "save_ms": save_ms, "restore_ms": s2.restore_ms,
           "restored_blocks": s2.restored_blocks,
           "prefix_restore_hits": snap.get("prefix_restore_hits", 0),
           "streams_equal": again == first}
    print(f"  prefix cache on disk: {out['blocks_saved']} blocks, "
          f"{written} bytes ({out['artifact_dtype']}), save {save_ms:.1f} "
          f"ms, restore {s2.restore_ms:.1f} ms ({s2.restored_blocks} "
          f"blocks); restored blocks hit {out['prefix_restore_hits']} "
          f"times; streams == the saving server's {out['streams_equal']}")
    if not out["prefix_restore_hits"] or not out["streams_equal"]:
        raise SystemExit("the restored prefix cache missed or changed "
                         "streams")
    return out


def durable_kv_phase():
    """Phase 27(c). Returns its readings."""
    from deeplearning4j_tpu_torch.models.zoo.transformer import TransformerLM
    print("phase 27(c): durable KV state at full width (phase 22's model, "
          "bf16, paged): preemption, migration, the prefix cache on disk")
    lm = TransformerLM(**FULL, dtype=torch.bfloat16, device="cuda")
    out = {"preemption": _preempt_ab(lm), "migration": _migration(lm),
           "prefix_cache": _prefix_on_disk(lm)}
    del lm
    torch.cuda.empty_cache()
    return out


def spec_kv_phase(fa):
    """Phase 27. Returns its readings. The remat step, the serving
    programs and the durable-KV verbs reach no kernel of the port: the
    counters are set to 0 first and must read 0 after it, the teaching
    steps of 27(b) excepted (counted apart)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    fa.reset_launches()
    out = {"remat": remat_phase()}
    launched = dict(fa.launches)
    t_b = time.perf_counter()
    out["speculation"] = speculation_phase(fa)
    t_c = time.perf_counter()
    out["durable_kv"] = durable_kv_phase()
    out["sub_phase_s"] = {"a": t_b - t_phase, "b": t_c - t_b,
                          "c": time.perf_counter() - t_c}
    for k, v in fa.launches.items():
        launched[k] = launched.get(k, 0) + v
    if any(launched.values()):
        raise SystemExit(f"phase 27 launched flash kernels: {launched}")
    out["flash_launches"] = launched
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 27 launched no kernel of the port (the teaching steps "
          f"apart: {out['speculation']['teach_launches']}): {launched}; "
          f"{out['phase_s']:.1f} s ({out['sub_phase_s']})")
    return out



# Phase 28: the fleet and the wire on phase 22's model. Each replica is one
# paged server of one configuration; chunked prefill (8 rows) gives the drain
# a prefilling phase to hand off, and the prefix cache is off so that no
# stream depends on what another request left resident.
FLEET_SERVER = dict(paged=True, slots=16, block_size=16, n_blocks=2048,
                    max_blocks_per_slot=16, prompt_buckets=(16, 64),
                    chunked_prefill=8, prefix_cache=False)
FLEET_REPLICAS, FLEET_REQUESTS, FLEET_LOAD, FLEET_SEED = 3, 64, 0.6, 28
FLEET_PROCS = 2
FLEET_HB_INTERVAL_S, FLEET_HB_TIMEOUT_S = 0.1, 5.0
FLEET_PUBLISH_TIMEOUT_S = 180.0


def _fleet_wait(pred, timeout, what):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise SystemExit(f"phase 28: never happened: {what}")
        time.sleep(0.0005)


def _fleet_factory(lm, made=None):
    """factory(name) of the in-process fleet: one FLEET_SERVER replica."""
    from deeplearning4j_tpu_torch.serving import (ContinuousDecodeServer,
                                                  ServingMetrics)

    def make(name):
        srv = ContinuousDecodeServer(lm, metrics=ServingMetrics(name=name),
                                     instance=name, **FLEET_SERVER)
        if made is not None:
            made[name] = srv
        return srv
    return make


def _fleet_counts(servers):
    """(dispatches, tokens_out) summed over `servers` (local or remote)."""
    d = t = 0
    for srv in servers:
        snap = srv.metrics.kind_snapshot()
        d += (snap.get("dispatches") or {}).get("value") or 0
        t += (snap.get("tokens_out") or {}).get("value") or 0
    return d, t


def _fleet_run(target, sched, servers):
    """run_load of `sched` through `target` (a FleetManager or a splitter):
    tokens/s, dispatches per token over `servers`, every future and its
    outcome keyed by schedule item."""
    from deeplearning4j_tpu_torch.serving import run_load
    futs = []
    d0, t0 = _fleet_counts(servers)
    res = run_load(target, sched, submit=_recording_submit(futs),
                   metrics=getattr(target, "metrics", None),
                   result_timeout=600)
    d1, t1 = _fleet_counts(servers)
    out = {"completed": res["completed"], "failed": res["failed"],
           "shed_at_submit": res["shed_at_submit"],
           "tokens_out": t1 - t0, "tokens_per_s": res["tokens_per_sec"],
           "duration_s": res["duration_s"],
           "latency_ms_p50": res["latency_ms"]["p50"],
           "latency_ms_p99": res["latency_ms"]["p99"],
           "dispatches": d1 - d0,
           "dispatches_per_token": (d1 - d0) / max(1, t1 - t0),
           "offered_rps": res["schedule"]["offered_rps"]}
    return out, futs


def _fleet_streams(futs):
    return {id(item): f.result(0) for item, f in futs
            if f.done() and not f.exception(0)}


def _fleet_inprocess(lm):
    """Phase 28(a). Returns (readings, manager, schedule, no-fault
    streams); the manager keeps running for (b) and (c)."""
    from deeplearning4j_tpu_torch.common.resilience import FaultInjector
    from deeplearning4j_tpu_torch.serving import (ContinuousDecodeServer,
                                                  FleetManager,
                                                  PoissonProcess,
                                                  RoundRobinSplitter,
                                                  build_schedule)
    out = {}
    vocab = FULL["vocab_size"]
    probe = ContinuousDecodeServer(lm, **FLEET_SERVER).start()
    try:
        _warm(probe)
        step_ms, step_trace = _step_ms(probe)
    finally:
        probe.stop()
    mean_new = sum(SPEC_NEW) / 2 - 0.5
    capacity = FLEET_REPLICAS * FLEET_SERVER["slots"] / (step_ms / 1e3) \
        / mean_new
    rate = FLEET_LOAD * capacity
    sched = build_schedule(PoissonProcess(rate), _CyclicMix(vocab),
                           FLEET_REQUESTS, seed=FLEET_SEED)
    out.update(step_ms=step_ms, step_trace=step_trace,
               capacity_rps=capacity, rate_rps=rate)
    print(f"  capacity from one replica's decode iteration "
          f"({step_ms:.3f} ms, 16 slots): {capacity:.1f} requests/s for "
          f"{FLEET_REPLICAS} replicas; offered {rate:.1f} requests/s "
          f"(Poisson, {FLEET_REQUESTS} requests, 6-15 prompt tokens, "
          f"16-139 new)")

    # zero added dispatches: one request at a time, the fleet's
    # round-robin router against the bare splitter, counters per replica
    seq_prompts = [list(sched.items[i]["prompt"]) for i in range(6)]
    made = {}
    with FleetManager(_fleet_factory(lm, made), n_replicas=FLEET_REPLICAS,
                      policy="round_robin", warmup=_warm) as rr:
        base = {n: _fleet_counts([made[n]]) for n in rr.replicas}
        seq_fleet = []
        for p in seq_prompts:
            seq_fleet.append(rr.generate(p, 48, timeout=600))
            rr.fleet_snapshot()
            rr.control_tick()
        per_fleet = [tuple(a - b for a, b in zip(_fleet_counts([made[n]]),
                                                 base[n]))
                     for n in rr.replicas]
    bare = [ContinuousDecodeServer(lm, **FLEET_SERVER).start()
            for _ in range(FLEET_REPLICAS)]
    try:
        for srv in bare:
            _warm(srv)
        base = [_fleet_counts([s]) for s in bare]
        split = RoundRobinSplitter(bare)
        seq_bare = [split.submit(p, 48).result(600) for p in seq_prompts]
        per_bare = [tuple(a - b for a, b in zip(_fleet_counts([s]), b0))
                    for s, b0 in zip(bare, base)]
        # the Poisson A/B arm: the same schedule through the bare servers
        bare_run, bare_futs = _fleet_run(split, sched, bare)
    finally:
        for srv in bare:
            srv.stop()
    out["sequential_ab"] = {"fleet": per_fleet, "bare": per_bare,
                            "streams_equal": seq_fleet == seq_bare}
    print(f"  one request at a time, round robin: fleet (dispatches, "
          f"tokens) per replica {per_fleet}, bare {per_bare}; streams "
          f"equal {seq_fleet == seq_bare}")
    if per_fleet != per_bare or seq_fleet != seq_bare:
        raise SystemExit("phase 28(a): the fleet changed the dispatches or "
                         "the streams of a sequential schedule")

    # the least-backlog fleet on the Poisson schedule, then again with a
    # replica killed mid-run
    inj = FaultInjector()
    mgr = FleetManager(_fleet_factory(lm, made), n_replicas=FLEET_REPLICAS,
                       fault_injector=inj, warmup=_warm).start()
    names0 = list(mgr.replicas)
    fleet_run, fleet_futs = _fleet_run(mgr, sched, [made[n] for n in
                                                    names0])
    nofault = _fleet_streams(fleet_futs)
    bare_streams = _fleet_streams(bare_futs)
    same = sum(nofault.get(k) == v for k, v in bare_streams.items())
    out["fleet"], out["bare"] = fleet_run, bare_run
    out["fleet_over_bare_tokens_per_s"] = (fleet_run["tokens_per_s"]
                                           / bare_run["tokens_per_s"])
    out["streams_equal_fleet_vs_bare"] = [same, len(bare_streams)]
    print(f"  Poisson A/B: fleet (least backlog) {fleet_run['tokens_per_s']}"
          f" tokens/s, {fleet_run['dispatches_per_token']:.4f} dispatches/"
          f"token, p99 {fleet_run['latency_ms_p99']} ms; bare round robin "
          f"{bare_run['tokens_per_s']} tokens/s, "
          f"{bare_run['dispatches_per_token']:.4f} dispatches/token, p99 "
          f"{bare_run['latency_ms_p99']} ms; streams equal {same}/"
          f"{len(bare_streams)}")
    if fleet_run["failed"] or bare_run["failed"] or same != FLEET_REQUESTS:
        raise SystemExit("phase 28(a): a request failed or a fleet stream "
                         "differs from the bare servers'")

    m = mgr.metrics
    before = {k: m.count_value(k) for k in ("received", "completed",
                                            "failed")}
    futs = []
    from deeplearning4j_tpu_torch.serving import run_load
    done = threading.Event()
    box = {}

    def load():
        try:
            box["res"] = run_load(mgr, sched, submit=_recording_submit(futs),
                                  result_timeout=600)
        except BaseException as e:   # noqa: BLE001 - reported below
            box["err"] = e
        finally:
            done.set()

    # the sever lands on the first replica once it has decoded 256 tokens
    # of this run
    victim = mgr.replicas[0]
    mark = made[victim].metrics.count_value("tokens_out") + 256
    t = threading.Thread(target=load, name="fleet-load")
    t.start()
    _fleet_wait(lambda: made[victim].metrics.count_value("tokens_out")
                >= mark, 120, "the victim decoding mid-run")
    with mgr._lock:
        aboard = [r.outer for r in mgr._live.values()
                  if r.replica == victim]
    inj.plan("fleet.replica", on_call=inj.calls("fleet.replica"),
             sever=True, exc=None)
    tick = mgr.control_tick()
    t.join(600)
    if "err" in box or not done.is_set():
        raise SystemExit(f"phase 28(a): the crash run did not finish: "
                         f"{box.get('err')!r}")
    after = {k: m.count_value(k) for k in before}
    delta = {k: after[k] - before[k] for k in before}
    unresolved = sum(not f.done() for _, f in futs)
    crash = _fleet_streams(futs)
    differ = [k for k, v in crash.items() if nofault.get(k) != v]
    # the requests aboard the killed replica, replayed: each against its
    # prompt alone on a quiet replica of the same configuration
    by_fut = {f: item for item, f in futs}
    quiet = ContinuousDecodeServer(lm, **FLEET_SERVER).start()
    try:
        _warm(quiet)
        replayed_equal = [
            quiet.generate(list(by_fut[f]["prompt"]),
                           by_fut[f]["max_new"], timeout=600)
            == f.result(0) for f in aboard if f in by_fut]
    finally:
        quiet.stop()
    new_names = sorted(set(mgr.replicas) - set(names0))
    snap = mgr.fleet_snapshot()
    out["crash"] = {
        "victim": victim, "aboard": len(aboard), "tick": {
            k: tick[k] for k in ("backfilled", "n_replicas", "replicas")},
        "admitted": delta["received"], "completed": delta["completed"],
        "failed": delta["failed"], "unresolved": unresolved,
        "streams_differing_from_no_fault": len(differ),
        "replayed_equal_quiet": [sum(replayed_equal), len(replayed_equal)],
        "failover_resubmitted": snap["fleet_failover_resubmitted"],
        "replica_dead": snap["fleet_replica_dead"],
        "backfilled_as": new_names, "tokens_per_s":
            box["res"]["tokens_per_sec"]}
    print(f"  crash: fleet.replica severed {victim} mid-run with "
          f"{len(aboard)} requests aboard; admitted {delta['received']} = "
          f"completed {delta['completed']} + failed {delta['failed']}, "
          f"{unresolved} unresolved; {len(differ)} streams differ from the "
          f"no-fault run; replayed == quiet replica "
          f"{sum(replayed_equal)}/{len(replayed_equal)}; backfilled "
          f"{tick['backfilled']} as {new_names}")
    if (unresolved or delta["received"] != delta["completed"]
            + delta["failed"] or delta["failed"] or differ
            or not aboard or not all(replayed_equal)
            or tick["backfilled"] != 1
            or tick["n_replicas"] != FLEET_REPLICAS
            or len(new_names) != 1 or new_names[0] in names0
            or victim in mgr.replicas):
        raise SystemExit(f"phase 28(a): the crash broke a guarantee: "
                         f"{out['crash']}")
    return out, mgr, made, sched, nofault



def _fleet_drain(lm, mgr, made):
    """Phase 28(b): scale_down one replica while it holds decode-phase,
    prefilling and queued requests. Returns its readings."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import ContinuousDecodeServer
    rng = np.random.default_rng(FLEET_SEED + 1)
    vocab = FULL["vocab_size"]
    names = list(mgr.replicas)
    victim = names[-1]
    short = [rng.integers(1, vocab, int(rng.integers(6, 16))).tolist()
             for _ in range(12 * len(names))]
    long = [rng.integers(1, vocab, int(rng.integers(48, 65))).tolist()
            for _ in range(8 * len(names))]
    seen = {}
    srv = made[victim]
    drain_now = srv._drain_now

    def recording_drain_now(migrate):
        # the serve thread's hand-off: the victim's state as it leaves
        live = [r for r in srv._slot_req if r is not None]
        seen["decoding"] = sum(r.pf_next is None for r in live)
        seen["prefilling"] = sum(r.pf_next is not None for r in live)
        seen["queued"] = (sum(not r.future.done()
                              for r in list(srv._q.queue))
                          + len(srv._mem_wait))
        t0 = time.perf_counter()
        migrated, replayed = drain_now(migrate)
        seen["extract_ms"] = (time.perf_counter() - t0) * 1e3
        seen["artifact_bytes"] = sum(a.nbytes for _, a in migrated)
        seen["migrated"], seen["replayed"] = len(migrated), len(replayed)
        return migrated, replayed

    srv._drain_now = recording_drain_now
    futs = [(p, 139, mgr.submit(p, 139)) for p in short]
    _fleet_wait(lambda: sum(r is not None and r.pf_next is None
                            and len(r.generated) >= 8
                            for r in srv._slot_req) >= 8, 120,
                "eight decode-phase requests on the victim")
    futs += [(p, 64, mgr.submit(p, 64)) for p in long]
    _fleet_wait(lambda: any(r is not None and r.pf_next is not None
                            for r in srv._slot_req), 120,
                "a prefilling request on the victim")
    t0 = time.perf_counter()
    mgr.scale_down(victim)
    drain_ms = (time.perf_counter() - t0) * 1e3
    got = [f.result(600) for _, _, f in futs]
    ref_srv = ContinuousDecodeServer(lm, **FLEET_SERVER).start()
    try:
        _warm(ref_srv)
        refs = [f.result(600) for f in
                [ref_srv.submit(p, n) for p, n, _ in futs]]
    finally:
        ref_srv.stop()
    equal = sum(a == b for a, b in zip(got, refs))
    migrated_in = sum(made[n].metrics.count_value("migrated")
                      for n in mgr.replicas)
    out = dict(seen, victim=victim, scale_down_ms=drain_ms,
               ms_per_migrated=drain_ms / max(1, seen.get("migrated", 0)),
               streams_equal=[equal, len(futs)], migrated_in=migrated_in,
               replica_drained=mgr.fleet_snapshot()[
                   "fleet_replica_drained"])
    print(f"  drain: scale_down({victim}) with {seen.get('decoding')} "
          f"decoding, {seen.get('prefilling')} prefilling and "
          f"{seen.get('queued')} queued: {seen.get('migrated')} migrated "
          f"({seen.get('artifact_bytes')} artifact bytes, extraction "
          f"{seen.get('extract_ms', 0):.1f} ms on the serve thread), "
          f"{seen.get('replayed')} replayed; scale_down {drain_ms:.1f} ms, "
          f"{out['ms_per_migrated']:.2f} ms per migrated request; streams "
          f"== a replica of the same configuration {equal}/{len(futs)}")
    if (equal != len(futs) or not seen.get("migrated")
            or not seen.get("prefilling") or not seen.get("queued")
            or seen["replayed"] < seen["prefilling"] + seen["queued"]
            or migrated_in < seen["migrated"]
            or victim in mgr.replicas):
        raise SystemExit(f"phase 28(b): the drain broke a guarantee: {out}")
    return out


def _fleet_canary(lm, mgr, made):
    """Phase 28(c): a NaN rollout rolls back before any swap, a healthy
    one rolls forward and a spawn inherits it."""
    from deeplearning4j_tpu_torch.models.zoo.transformer import TransformerLM
    from deeplearning4j_tpu_torch.serving.decode import _param_fingerprint
    names = list(mgr.replicas)
    swaps = {n: made[n].metrics.count_value("swaps") for n in names}
    bad = TransformerLM(**dict(FULL, seed=1), dtype=torch.bfloat16,
                        device="cuda")
    with torch.no_grad():
        bad.blocks[-1].mlp.w2[3, 5] = float("nan")
    t0 = time.perf_counter()
    nan = mgr.rollout(bad)
    nan_ms = (time.perf_counter() - t0) * 1e3
    swaps_after = {n: made[n].metrics.count_value("swaps") for n in names}
    del bad
    new = TransformerLM(**dict(FULL, seed=1), dtype=torch.bfloat16,
                        device="cuda")
    want = _param_fingerprint(new.aux, new.blocks)

    def traffic():
        for f in [mgr.submit([5, 6, 7, 8, 9, 10], 16) for _ in range(8)]:
            f.result(600)

    t0 = time.perf_counter()
    good = mgr.rollout(new, watch_ticks=1, traffic=traffic)
    good_ms = (time.perf_counter() - t0) * 1e3
    tags = {n: _param_fingerprint(*made[n].current_params())
            for n in mgr.replicas}
    spawned = mgr.scale_up()
    spawned_tag = _param_fingerprint(*made[spawned].current_params())
    out = {"nan": {"status": nan["status"], "reason": nan.get("reason"),
                   "ms": nan_ms, "swaps_before": swaps,
                   "swaps_after": swaps_after},
           "healthy": {"status": good["status"], "ms": good_ms,
                       "fingerprint": want,
                       "replicas_on_new": sum(t == want
                                              for t in tags.values()),
                       "spawned": spawned,
                       "spawn_inherits": spawned_tag == want}}
    print(f"  canary: NaN weights {nan['status']} ({nan.get('reason')}) in "
          f"{nan_ms:.1f} ms, swaps per replica {swaps} -> {swaps_after}; "
          f"healthy weights {good['status']} in {good_ms:.0f} ms, "
          f"{out['healthy']['replicas_on_new']}/{len(tags)} replicas on "
          f"fingerprint {want}, spawn {spawned} inherits "
          f"{spawned_tag == want}")
    if (nan["status"] != "rolled_back" or nan.get("reason") != "nan_screen"
            or swaps_after != swaps or good["status"] != "rolled_forward"
            or any(t != want for t in tags.values())
            or spawned_tag != want):
        raise SystemExit(f"phase 28(c): the canary broke a guarantee: {out}")
    return out, new



def fleet_replica_main(name, port_file, identity_file):
    """Phase 28(d)'s replica process: phase 22's model (the same seed, so
    the same weights as the smoke's) in one FLEET_SERVER server on cuda:0,
    warmed, behind run_replica_server until STOP, KILL or DRAIN."""
    from deeplearning4j_tpu_torch.models.zoo.transformer import TransformerLM
    from deeplearning4j_tpu_torch.serving import (ContinuousDecodeServer,
                                                  ServingMetrics,
                                                  run_replica_server)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    lm = TransformerLM(**FULL, dtype=torch.bfloat16, device="cuda:0")
    srv = ContinuousDecodeServer(lm, metrics=ServingMetrics(name=name),
                                 instance=name, **FLEET_SERVER).start()
    _warm(srv)
    run_replica_server(srv, port_file=port_file,
                       identity_file=identity_file)


def _fleet_processes(tmp):
    """Start FLEET_PROCS spawn children on cuda:0; returns ({name: port},
    {name: process}). A child that exits before it publishes its port
    fails the phase."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    names = [f"i{i}" for i in range(FLEET_PROCS)]
    procs = {}
    for n in names:
        procs[n] = ctx.Process(target=fleet_replica_main,
                               args=(n, os.path.join(tmp, f"{n}.port"),
                                     os.path.join(tmp, f"{n}.json")))
        procs[n].start()
    ports = {}
    t0 = time.monotonic()
    while len(ports) < len(names):
        for n in names:
            pf = os.path.join(tmp, f"{n}.port")
            if n not in ports and os.path.exists(pf):
                ports[n] = int(open(pf).read())
            elif n not in ports and not procs[n].is_alive():
                raise SystemExit(f"phase 28(d): replica process {n} exited "
                                 f"({procs[n].exitcode}) before publishing "
                                 f"its port")
        if time.monotonic() - t0 > FLEET_PUBLISH_TIMEOUT_S:
            raise SystemExit("phase 28(d): the replica processes never "
                             "published their ports")
        time.sleep(0.05)
    return ports, procs


def _fleet_wire(lm, new, sched, inproc):
    """Phase 28(d): two replica processes behind RemoteReplicas and a
    journaled manager. Returns its readings."""
    import signal
    import tempfile

    from deeplearning4j_tpu_torch.common.resilience import FaultInjector
    from deeplearning4j_tpu_torch.parallel.ps_transport import pack_leaves
    from deeplearning4j_tpu_torch.models.zoo.transformer import tree_leaves
    from deeplearning4j_tpu_torch.serving import (ContinuousDecodeServer,
                                                  FleetManager,
                                                  RemoteReplica,
                                                  StaleEpochError)
    out = {"heartbeat_timeout_s": FLEET_HB_TIMEOUT_S,
           "heartbeat_interval_s": FLEET_HB_INTERVAL_S}
    tmp = tempfile.mkdtemp(prefix="fleet28-")
    jpath = os.path.join(tmp, "fleet.journal")
    inj = FaultInjector()
    t0 = time.perf_counter()
    ports, procs = _fleet_processes(tmp)
    out["processes_up_s"] = time.perf_counter() - t0

    def factory(name):
        return RemoteReplica("127.0.0.1", ports[name], name=name,
                             heartbeat_interval=FLEET_HB_INTERVAL_S,
                             fault_injector=inj)

    mgr = mgr2 = None
    try:
        mgr = FleetManager(factory, n_replicas=FLEET_PROCS, min_replicas=1,
                           heartbeat_timeout=FLEET_HB_TIMEOUT_S,
                           journal=jpath).start()
        clients = lambda m: [m.replica(n) for n in m.replicas]
        # tokens/s over the wire at (a)'s rate, on (a)'s schedule
        run, futs = _fleet_run(mgr, sched, clients(mgr))
        streams = _fleet_streams(futs)
        same = sum(inproc.get(k) == v for k, v in streams.items())
        out["wire"] = run
        out["wire_streams_equal_inprocess"] = [same, len(streams)]
        print(f"  wire: {FLEET_PROCS} replica processes, (a)'s schedule: "
              f"{run['tokens_per_s']} tokens/s, "
              f"{run['dispatches_per_token']:.4f} dispatches/token, p99 "
              f"{run['latency_ms_p99']} ms; streams equal to the in-process "
              f"fleet's {same}/{len(streams)}")
        if run["failed"] or len(streams) != FLEET_REQUESTS:
            raise SystemExit("phase 28(d): a request over the wire failed")

        # a STREAM severed on arrival: the retried SUBMIT deduplicates
        prompt = list(sched.items[0]["prompt"])
        d0 = {n: _fleet_counts([mgr.replica(n)]) for n in mgr.replicas}
        clean = mgr.generate(prompt, 64, timeout=600)
        d1 = {n: _fleet_counts([mgr.replica(n)]) for n in mgr.replicas}
        recv = lambda: sum(
            (mgr.replica(n).metrics.kind_snapshot().get("received")
             or {}).get("value") or 0 for n in mgr.replicas)
        r0 = recv()
        inj.plan("serve.wire.stream", on_call=inj.calls("serve.wire.stream"),
                 sever=True, exc=None)
        retried = mgr.generate(prompt, 64, timeout=600)
        d2 = {n: _fleet_counts([mgr.replica(n)]) for n in mgr.replicas}
        clean_d = sum(d1[n][0] - d0[n][0] for n in d0)
        retry_d = sum(d2[n][0] - d1[n][0] for n in d0)
        snap = mgr.fleet_snapshot()
        out["dedup"] = {"equal": retried == clean,
                        "dispatches_clean": clean_d,
                        "dispatches_severed": retry_d,
                        "decoded": recv() - r0,
                        "wire_retries": snap["fleet_wire_retries"],
                        "wire_reconnects": snap["fleet_wire_reconnects"]}
        print(f"  dedup: a severed STREAM -> {snap['fleet_wire_retries']} "
              f"wire retry, {recv() - r0} decode, dispatches {retry_d} "
              f"(the same request unsevered: {clean_d}), stream equal "
              f"{retried == clean}")
        if (retried != clean or retry_d != clean_d or recv() - r0 != 1
                or snap["fleet_wire_retries"] != 1):
            raise SystemExit(f"phase 28(d): the retried SUBMIT decoded "
                             f"again or changed: {out['dedup']}")

        # SIGKILL one process with requests aboard: reaped, failed over
        victim, survivor = "i1", "i0"
        prompts = [list(sched.items[i]["prompt"]) for i in range(8)]
        refs = [mgr.replica(survivor).generate(p, 96, timeout=600)
                for p in prompts]
        kfuts = [mgr.submit(p, 96) for p in prompts]
        _fleet_wait(lambda: any(
            r.replica == victim for r in list(mgr._live.values())), 60,
            "a request aboard the victim process")
        pre = mgr.fleet_view().flat(survivor).get("completed") or 0

        def victim_down():
            try:
                return not mgr.replica(victim).alive
            except KeyError:        # the failover path already removed it
                return True

        t_kill = time.perf_counter()
        os.kill(procs[victim].pid, signal.SIGKILL)
        _fleet_wait(victim_down, 60, "the killed process read as dead")
        t_dead = time.perf_counter()
        tick = mgr.control_tick()
        t_reaped = time.perf_counter()
        got = [f.result(600) for f in kfuts]
        procs[victim].join(30)
        snap = mgr.fleet_snapshot()
        out["sigkill"] = {
            "kill_to_not_alive_ms": (t_dead - t_kill) * 1e3,
            "kill_to_reaped_ms": (t_reaped - t_kill) * 1e3,
            "state": tick["states"].get(victim),
            "equal_survivor_solo": [sum(a == b for a, b in zip(got, refs)),
                                    len(refs)],
            "failover_resubmitted": snap["fleet_failover_resubmitted"]}
        print(f"  SIGKILL {victim}: not alive after "
              f"{out['sigkill']['kill_to_not_alive_ms']:.1f} ms, reaped by "
              f"the tick at {out['sigkill']['kill_to_reaped_ms']:.1f} ms; "
              f"{snap['fleet_failover_resubmitted']} failovers, streams == "
              f"the survivor's own {out['sigkill']['equal_survivor_solo']}")
        if (tick["states"].get(victim) != "dead" or got != refs
                or not snap["fleet_failover_resubmitted"]):
            raise SystemExit(f"phase 28(d): the SIGKILL broke a guarantee: "
                             f"{out['sigkill']}")

        # the manager dies without stop(); recover() re-adopts and fences
        stale, mgr = mgr, None
        j, stale._journal = stale._journal, None
        j.close()
        mgr2 = FleetManager.recover(
            factory, jpath, redial=lambda name, ident: factory(name),
            n_replicas=1, min_replicas=1,
            heartbeat_timeout=FLEET_HB_TIMEOUT_S)
        after = mgr2.fleet_view().flat(survivor).get("completed") or 0
        fenced = None
        try:
            stale.replica(survivor).drain(timeout=30.0)
        except StaleEpochError as e:
            fenced = type(e).__name__
        snap2 = mgr2.fleet_snapshot()
        out["recover"] = {"epoch": mgr2.epoch,
                          "adopted": mgr2.metrics.count_value(
                              "replicas_adopted"),
                          "replicas": mgr2.replicas, "stale_op": fenced,
                          "fenced_ops": snap2["fleet_fenced_ops"],
                          "completed_before_after": [pre, after]}
        print(f"  recover: epoch {mgr2.epoch}, re-adopted {mgr2.replicas}; "
              f"the stale manager's DRAIN -> {fenced}; completed on "
              f"{survivor} {pre} -> {after}")
        if (mgr2.replicas != [survivor] or fenced != "StaleEpochError"
                or after < pre or mgr2.epoch != 2):
            raise SystemExit(f"phase 28(d): recovery broke a guarantee: "
                             f"{out['recover']}")
        for n in list(stale.states()):
            try:
                stale.replica(n)._shutdown_local(RuntimeError("stale"),
                                                 dead=False)
            except Exception:   # noqa: BLE001 - a tombstone has no client
                pass
        stale._running = False

        # SWAP the full-width weights across the wire; the replica's
        # version tag (the fingerprint its artifacts carry) must then be
        # the new weights', and a request exported from it resumes on an
        # in-process replica of the new weights
        from deeplearning4j_tpu_torch.serving.decode import \
            _param_fingerprint
        nbytes = len(pack_leaves(tree_leaves(new.aux, new.blocks)))
        rr = mgr2.replica(survivor)
        t0 = time.perf_counter()
        rr.swap(new)
        swap_ms = (time.perf_counter() - t0) * 1e3
        want = _param_fingerprint(new.aux, new.blocks)
        probe = list(sched.items[1]["prompt"])
        local = ContinuousDecodeServer(new, **FLEET_SERVER).start()
        try:
            _warm(local)
            local_new = local.generate(probe, 139, timeout=600)
            tok0 = _fleet_counts([rr])[1]
            fut = rr.submit(probe, 139)
            _fleet_wait(lambda: _fleet_counts([rr])[1] >= tok0 + 8, 60,
                        "the swapped replica decoding")
            art = rr.migrate_out(fut)
            resumed = local.migrate_in(art).result(600)
        finally:
            local.stop()
        out["swap"] = {"bytes": nbytes, "ms": swap_ms, "tag": art.tag,
                       "tag_is_new_weights": art.tag == want,
                       "exported_at": len(art.generated),
                       "resumed_equals_inprocess": resumed == local_new}
        print(f"  SWAP of the full weights over the wire: {nbytes} bytes in "
              f"{swap_ms:.1f} ms ({nbytes / swap_ms / 1e6:.2f} GB/s); the "
              f"replica's version tag {art.tag} is the new weights' "
              f"{art.tag == want}; a request exported after "
              f"{len(art.generated)} tokens resumes in-process, stream == "
              f"an in-process replica's {resumed == local_new}")
        if art.tag != want:
            raise SystemExit("phase 28(d): the swapped replica does not "
                             "serve the new weights")
    finally:
        for m in (mgr, mgr2):
            if m is not None:
                m.stop(timeout=60)
        for p in procs.values():
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    out["exit_codes"] = {n: p.exitcode for n, p in procs.items()}
    return out


def fleet_phase(fa):
    """Phase 28. Returns its readings. The fleet, the journal and the wire
    are host code over the paged serving programs: no kernel of the port
    is on this path, so the counters are set to 0 first and must read 0
    after it (the replica processes' own counters are theirs)."""
    from deeplearning4j_tpu_torch.models.zoo.transformer import TransformerLM
    print(f"phase 28: FleetManager over {FLEET_REPLICAS} paged replicas of "
          f"phase 22's model (bf16, full width), then {FLEET_PROCS} replica "
          f"processes on cuda:0 behind the wire")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    fa.reset_launches()
    lm = TransformerLM(**FULL, dtype=torch.bfloat16, device="cuda")
    out = {"config": dict(FLEET_SERVER, replicas=FLEET_REPLICAS,
                          requests=FLEET_REQUESTS, load=FLEET_LOAD)}
    t = time.perf_counter()
    out["a"], mgr, made, sched, nofault = _fleet_inprocess(lm)
    out["sub_phase_s"] = {"a": time.perf_counter() - t}
    try:
        t = time.perf_counter()
        out["b"] = _fleet_drain(lm, mgr, made)
        out["sub_phase_s"]["b"] = time.perf_counter() - t
        t = time.perf_counter()
        out["c"], new = _fleet_canary(lm, mgr, made)
        out["sub_phase_s"]["c"] = time.perf_counter() - t
    finally:
        mgr.stop(timeout=120)
    t = time.perf_counter()
    out["d"] = _fleet_wire(lm, new, sched, nofault)
    out["sub_phase_s"]["d"] = time.perf_counter() - t
    out["wire_over_inprocess_tokens_per_s"] = (
        out["d"]["wire"]["tokens_per_s"] / out["a"]["fleet"]["tokens_per_s"])
    launched = dict(fa.launches)
    if any(launched.values()):
        raise SystemExit(f"phase 28 launched flash kernels: {launched}")
    out["flash_launches"] = launched
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 28 launched no kernel of the port: {launched}; wire / "
          f"in-process tokens/s {out['wire_over_inprocess_tokens_per_s']:.3f}"
          f"; {out['phase_s']:.1f} s ({out['sub_phase_s']})")
    return out


# ---------------------------------------------------------------------------
# Phase 29: the training tools, the containers' surface and the classic CNNs
# ---------------------------------------------------------------------------
TOOLS_LENET_B, TOOLS_LENET_BATCHES, TOOLS_FUSED_FITS = 512, 16, 5
TOOLS_ES_BATCHES, TOOLS_ES_VAL = 8, 2
PROF_B, PROF_START, PROF_STEPS = 128, 5, 3
CNN_BATCH = {"alexnet": 128, "vgg16": 64, "googlenet": 128}
CNN_TOY_HW = {"alexnet": 64, "vgg16": 32, "googlenet": 64}
CNN_STEPS = 4
# Phase 29(g)'s toy copies, card against CPU, dropout off: the f32 forward
# within 1e-5 of the largest output (tier-1 reads <= 1.7e-6 between XLA
# and oneDNN on the CPU); the f32 step's parameter change within 1e-3
# relative L2 (tier-1: GoogLeNet's f32 gradients differ by 1.6e-4 relative
# L2 between XLA and oneDNN, 1e-3 at its stem, where its f64 gradients
# agree to 1.4e-15); the f64 step within 1e-9 of the largest change.
CNN_FWD_TOL, CNN_F32_STEP_L2, CNN_F64_STEP_TOL = 1e-5, 1e-3, 1e-9
SOLVER_TOL = 1e-8   # card against CPU, f64, 10 iterations: relative


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN's deterministic algorithms inside (the port then picks them by
    heuristics, the same for a shape in every call), for comparisons that
    must be bit-equal on the card."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _load_tier1(name):
    """A tier-1 test module by its file (its nets and data builders; its
    JAX fixtures are not run)."""
    import importlib.util
    path = Path(__file__).resolve().parent / "tests" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_tier1_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _EventMarks:
    """A listener recording a CUDA event at each iteration_done: the
    device time between two calls."""

    def __init__(self):
        self.events = []

    def iteration_done(self, model, iteration):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append(e)

    def ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.events,
                                                  self.events[1:])]


def _lenet_data(seed, rows, n):
    """n numpy batches of config #1's shape (784 features, 10 classes),
    labelled by one fixed linear map, so that a held-out set can improve."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(290).standard_normal((784, 10))
    out = []
    for _ in range(n):
        x = rng.random((rows, 784), dtype=np.float32)
        out.append(DataSet(x, np.eye(10, dtype=np.float32)[
            np.argmax((x - 0.5) @ w, axis=1)]))
    return out


def tools_f1():
    """Phase 29(a): predict, get_layer and n_layers on the card."""
    import numpy as np

    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    print("phase 29(a): LeNet bf16 on the card: predict, get_layer, "
          "n_layers")
    with _cudnn_deterministic():
        net = lenet(data_type="bfloat16")
        x = np.random.default_rng(291).random((256, 784), dtype=np.float32)
        pred = net.predict(x)
        want = net.output(x).argmax(-1)
    layers_ok = (net.n_layers == len(net.conf.layers) == 6 and all(
        net.get_layer(i) is net.conf.layers[i] for i in range(6)))
    ok = (pred.dtype.kind == "i" and pred.shape == (256,)
          and np.array_equal(pred, want) and layers_ok)
    print(f"  predict == output(...).argmax(-1) on 256 rows: "
          f"{np.array_equal(pred, want)}; n_layers {net.n_layers}, "
          f"get_layer(i) is conf.layers[i]: {layers_ok}")
    if not ok:
        raise SystemExit("phase 29(a): predict / get_layer / n_layers")
    return {"predict_equal": True, "n_layers": net.n_layers,
            "classes_seen": int(len(set(pred.tolist())))}


def tools_listeners():
    """Phase 29(b): the listeners at config #1's width. Returns its
    readings."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    from deeplearning4j_tpu_torch.optimize import (
        CollectScoresIterationListener, PerformanceListener)
    B, n = TOOLS_LENET_B, TOOLS_LENET_BATCHES
    print(f"phase 29(b): listeners on LeNet bf16, batch {B}, {n} batches a "
          f"fit (phase 26's data): PerformanceListener beside CUDA events; "
          f"fused_steps({FUSED_K}) with and without a "
          f"CollectScoresIterationListener")
    gen = torch.Generator(device="cuda").manual_seed(261)
    x = torch.rand((B, 784), generator=gen, device="cuda")
    y = torch.nn.functional.one_hot(torch.randint(
        0, 10, (B,), generator=gen, device="cuda"), 10).float()
    ds = DataSet(x, y)

    def epoch():
        return ListDataSetIterator([ds] * n)

    out = {}
    net = lenet(data_type="bfloat16")
    net.fit(epoch())                       # cuDNN's search
    perf, marks = PerformanceListener(), _EventMarks()
    net.set_listeners(perf, marks)
    net.fit(epoch())
    dev_ms = marks.ms()
    host = [s for _, _, s in perf.history]
    if len(host) != n - 1 or len(dev_ms) != n - 1:
        raise SystemExit(f"PerformanceListener saw {len(host)} intervals, "
                         f"the events {len(dev_ms)}; want {n - 1}")
    out["performance_listener"] = {
        "median_samples_per_s": _p(host, 50),
        "median_images_per_s_cuda_events": _p(
            [B * 1e3 / ms for ms in dev_ms], 50),
        "median_step_ms_cuda_events": _p(dev_ms, 50),
        "median_step_ms_host": _p([1e3 * dt for _, dt, _ in
                                   perf.history], 50),
        "last_batch_size": net._last_batch_size}
    r = out["performance_listener"]
    print(f"  PerformanceListener median {r['median_samples_per_s']:.0f} "
          f"samples/s (host clock between calls, "
          f"{r['median_step_ms_host']:.3f} ms); CUDA events between the "
          f"same calls "
          f"{r['median_images_per_s_cuda_events']:.0f} images/s "
          f"({r['median_step_ms_cuda_events']:.3f} ms); _last_batch_size "
          f"{net._last_batch_size}")
    if net._last_batch_size != B or not r["median_samples_per_s"] > 0:
        raise SystemExit(f"PerformanceListener read {r}")

    quiet = lenet(data_type="bfloat16").fused_steps(FUSED_K)
    heard = lenet(data_type="bfloat16").fused_steps(FUSED_K)
    collect = CollectScoresIterationListener()
    heard.set_listeners(collect)
    seen = _record_steps(heard)
    nets = {"fused8": quiet, "fused8_listener": heard}
    rates = {k: [] for k in nets}

    def timed_fit(name):
        net = nets[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(epoch())
        float(net._score)
        torch.cuda.synchronize()
        return B * n / (time.perf_counter() - t0)

    for name in nets:                      # the capture
        timed_fit(name)
    for i in range(TOOLS_FUSED_FITS):
        for name in (list(nets) if i % 2 == 0 else list(nets)[::-1]):
            rates[name].append(timed_fit(name))
    got = [s for _, s in collect.scores]
    want = _step_scores(seen)
    its = [i for i, _ in collect.scores]
    if got != want or its != list(range(len(want))) or \
            len(want) != n * (TOOLS_FUSED_FITS + 1):
        raise SystemExit(f"the listener's scores are not the groups' "
                         f"per-step scores: {got[:4]} vs {want[:4]}")
    _same_training_state("fused8 with and without a listener", quiet, heard)
    for name in nets:
        out[name] = {"images_per_s": rates[name],
                     "median_images_per_s": _p(rates[name], 50),
                     "graph_replays": nets[name].fused_counts[
                         "graph_replays"]}
        print(f"  {name}: images/s {[round(v) for v in rates[name]]}, "
              f"median {out[name]['median_images_per_s']:.0f}; "
              f"{nets[name].fused_counts['graph_replays']} graph replays")
    out["listener_over_quiet"] = (out["fused8_listener"]["median_images_per_s"]
                                  / out["fused8"]["median_images_per_s"])
    out["listener_scores"] = len(got)
    print(f"  the listener heard {len(got)} steps, each score equal to its "
          f"group's; with / without: {out['listener_over_quiet']:.3f}")
    return out


def tools_early_stopping():
    """Phase 29(c): early stopping on the card. Returns its readings."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingTrainer, LocalFileModelSaver,
        MaxEpochsTerminationCondition,
        ScoreImprovementEpochTerminationCondition)
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    from deeplearning4j_tpu_torch.parallel import (
        EarlyStoppingParallelTrainer, MasterDataSetLossCalculator,
        ParameterAveragingTrainingMaster, TpuEarlyStoppingTrainer)
    from deeplearning4j_tpu_torch.util.sharded_checkpoint import \
        ShardedModelSaver
    B = TOOLS_LENET_B
    print(f"phase 29(c): early stopping on LeNet bf16, {TOOLS_ES_BATCHES} "
          f"training batches of {B}, {TOOLS_ES_VAL} held out, under cuDNN's "
          f"deterministic algorithms")
    batches = _lenet_data(292, B, TOOLS_ES_BATCHES)
    held = _lenet_data(293, B, TOOLS_ES_VAL)
    probe = held[0].features
    root = Path(__file__).resolve().parent / "build" / "phase29_es"
    shutil.rmtree(root, ignore_errors=True)

    def conf(saver=None, calc=None, *conds):
        b = (EarlyStoppingConfiguration.Builder()
             .score_calculator(calc or DataSetLossCalculator(
                 ListDataSetIterator(held)))
             .epoch_termination_conditions(*conds))
        return (b.model_saver(saver) if saver is not None else b).build()

    def recording(saver, what):
        seen = []
        save = saver.save_best_model

        def save_best_model(net, score):
            seen.append(what(net))
            save(net, score)

        saver.save_best_model = save_best_model
        return seen

    out = {}
    with _cudnn_deterministic():
        # the zip saver: the best model restored from bestModel.bin gives
        # the outputs the net gave at its best epoch, bit for bit
        saver = LocalFileModelSaver(root / "zip")
        at_best = recording(saver, lambda n: n.output(probe))
        net = lenet(data_type="bfloat16")
        t0 = time.perf_counter()
        res = EarlyStoppingTrainer(conf(
            saver, None, ScoreImprovementEpochTerminationCondition(2),
            MaxEpochsTerminationCondition(5)), net,
            ListDataSetIterator(batches)).fit()
        fit_s = time.perf_counter() - t0
        best = res.get_best_model()
        bit_equal = bool(np.array_equal(best.output(probe), at_best[-1]))
        out["zip"] = {"best_epoch": res.best_model_epoch,
                      "total_epochs": res.total_epochs,
                      "reason": res.termination_reason,
                      "details": res.termination_details,
                      "score_vs_epoch": {str(k): v for k, v in
                                         res.score_vs_epoch.items()},
                      "fit_s": fit_s, "best_restored_bit_equal": bit_equal,
                      "best_on": str(best.device)}
        print(f"  LocalFileModelSaver: {res.total_epochs} epochs "
              f"({res.termination_details}), best epoch "
              f"{res.best_model_epoch}, {fit_s:.2f} s; bestModel.bin "
              f"restored on {best.device}, outputs bit-equal to the net's "
              f"at its best epoch: {bit_equal}")
        if not bit_equal or best.device.type != "cuda":
            raise SystemExit("phase 29(c): the best model's zip does not "
                             "restore the best epoch")

        # the parallel trainer in both modes is the trainer on one rank
        runs = {}
        for mode in ("trainer", 1, 2):
            net = lenet(data_type="bfloat16")
            es = conf(None, None, MaxEpochsTerminationCondition(3))
            it = ListDataSetIterator(batches)
            trainer = (EarlyStoppingTrainer(es, net, it) if mode == "trainer"
                       else EarlyStoppingParallelTrainer(
                           es, net, it, averaging_frequency=mode))
            r = trainer.fit()
            runs[mode] = (r.score_vs_epoch, net.params())
        same = all(runs[k][0] == runs["trainer"][0] and np.array_equal(
            runs[k][1], runs["trainer"][1]) for k in (1, 2))
        out["parallel_trainer_equals_trainer"] = same
        print(f"  EarlyStoppingParallelTrainer (one rank, k = 1 and 2) == "
              f"EarlyStoppingTrainer, scores and parameters bit-equal: "
              f"{same}")
        if not same:
            raise SystemExit("phase 29(c): the parallel trainer differs")

        # one epoch is one execute_training pass of the master
        net = lenet(data_type="bfloat16")
        tm = (ParameterAveragingTrainingMaster.Builder(B)
              .averaging_frequency(2).rdd_training_approach("direct")
              .build())
        r = TpuEarlyStoppingTrainer(conf(
            None, MasterDataSetLossCalculator(ListDataSetIterator(held)),
            MaxEpochsTerminationCondition(3),
            ScoreImprovementEpochTerminationCondition(2)), tm, net,
            DataSet.merge(batches)).fit()
        out["master"] = {"total_epochs": r.total_epochs,
                         "best_epoch": r.best_model_epoch,
                         "best_score": r.best_model_score,
                         "iterations": net.conf.iteration_count}
        print(f"  TpuEarlyStoppingTrainer over the TrainingMaster: "
              f"{r.total_epochs} epochs, best {r.best_model_epoch} "
              f"({r.best_model_score:.4f}), {net.conf.iteration_count} steps")
        if (r.best_model is None or not math.isfinite(r.best_model_score)
                or net.conf.iteration_count != TOOLS_ES_BATCHES
                * r.total_epochs):
            raise SystemExit(f"phase 29(c) master: {out['master']}")

        # the sharded saver: the best model holds the best epoch's masters
        saver = ShardedModelSaver(str(root / "sharded"),
                                  lambda: lenet(data_type="bfloat16"))
        at_best = recording(saver, lambda n: (n.params(), n.output(probe)))
        net = lenet(data_type="bfloat16")
        r = EarlyStoppingTrainer(conf(saver, None,
                                      MaxEpochsTerminationCondition(3)),
                                 net, ListDataSetIterator(batches)).fit()
        best = r.get_best_model()
        params_equal = bool(np.array_equal(best.params(), at_best[-1][0]))
        outputs_equal = bool(np.array_equal(best.output(probe),
                                            at_best[-1][1]))
        out["sharded"] = {"best_epoch": r.best_model_epoch,
                          "params_bit_equal": params_equal,
                          "outputs_bit_equal": outputs_equal}
        print(f"  ShardedModelSaver: best epoch {r.best_model_epoch}, "
              f"restored masters bit-equal {params_equal}, outputs "
              f"bit-equal {outputs_equal}")
        if not (params_equal and outputs_equal):
            raise SystemExit("phase 29(c): ShardedModelSaver's restore")
    return out


def tools_gradient_check():
    """Phase 29(d): tier-1's f64 conv + max-pool net and f64 GravesLSTM
    with masks pass check_gradients on the card."""
    from deeplearning4j_tpu_torch.gradientcheck import check_gradients
    G = _load_tier1("test_torch_gradient_check")
    print("phase 29(d): check_gradients on cuda:0, f64, cuDNN's "
          "deterministic algorithms: tier-1's conv + max-pool net (50 of "
          "its parameters) and GravesLSTM with masks (50)")
    out = {}
    with _cudnn_deterministic():
        x, y = G.cnn_data()
        pool = G.SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                  stride=(2, 2))
        net = G.cnn_net((pool,), device="cuda")
        t0 = time.perf_counter()
        out["conv_max_pool"] = check_gradients(net, x, y, max_rel_error=1e-4,
                                               subset=50)
        out["conv_s"] = time.perf_counter() - t0
        x, y, fmask, lmask = G.lstm_data()
        net = G.lstm_net(device="cuda")
        t0 = time.perf_counter()
        out["graves_lstm_masked"] = check_gradients(
            net, x, y, fmask=fmask, lmask=lmask, max_rel_error=1e-4,
            subset=50)
        out["lstm_s"] = time.perf_counter() - t0
    print(f"  conv + max pool: {out['conv_max_pool']} ({out['conv_s']:.2f} "
          f"s); GravesLSTM with masks: {out['graves_lstm_masked']} "
          f"({out['lstm_s']:.2f} s)")
    if not (out["conv_max_pool"] and out["graves_lstm_masked"]):
        raise SystemExit("phase 29(d): a gradient check failed on the card")
    return out


def tools_solvers():
    """Phase 29(e): the solvers on the card against the CPU."""
    from deeplearning4j_tpu_torch.optimize import Solver
    S = _load_tier1("test_torch_solvers")
    print(f"phase 29(e): the solvers on tier-1's f64 4-8-2 MLP, 10 "
          f"iterations, card against CPU (relative {SOLVER_TOL:g}); LBFGS "
          f"100 iterations on the card")
    x, y = S._xor_ish()
    out = {}
    for algo in S.ALGOS:
        got = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            got[dev] = Solver(S._net(algo, device=dev),
                              max_iterations=10).optimize(x, y)
            got[f"{dev}_s"] = time.perf_counter() - t0
        rel = abs(got["cuda"] - got["cpu"]) / abs(got["cpu"])
        out[algo] = dict(got, rel_err=rel)
        _check(f"{algo}: card {got['cuda']:.12g} ({got['cuda_s']:.2f} s) "
               f"vs CPU {got['cpu']:.12g}", rel, SOLVER_TOL)
    net = S._net("lbfgs", device="cuda")
    final = Solver(net, max_iterations=100).optimize(x, y)
    out["lbfgs_100"] = final
    print(f"  LBFGS 100 iterations on the card: {final:.3e} (< 0.3)")
    if not final < 0.3:
        raise SystemExit(f"phase 29(e): LBFGS reached {final}")
    return out


def tools_profiler():
    """Phase 29(f): ProfilerListener and summarize_trace on ResNet-50
    (config #2). Returns its readings."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.zoo.resnet import resnet50
    from deeplearning4j_tpu_torch.optimize.profiler import (ProfilerListener,
                                                            summarize_trace)
    B = PROF_B
    print(f"phase 29(f): ProfilerListener on ResNet-50 bf16, batch {B}, "
          f"224x224x3: {PROF_STEPS} steps traced after {PROF_START}, then "
          f"summarize_trace")
    torch.cuda.empty_cache()
    net = resnet50(data_type="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(296)
    x = torch.rand((B, 224, 224, 3), generator=gen, device="cuda")
    y = torch.nn.functional.one_hot(torch.randint(
        0, 1000, (B,), generator=gen, device="cuda"), 1000).float()
    ds = DataSet(x, y)
    logdir = Path(__file__).resolve().parent / "build" / "phase29_prof"
    shutil.rmtree(logdir, ignore_errors=True)
    listener = ProfilerListener(logdir, start_iteration=PROF_START,
                                num_iterations=PROF_STEPS)
    net.set_listeners(listener)
    t0 = time.perf_counter()
    for _ in range(PROF_START + PROF_STEPS):
        net.fit(ds)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    if not listener.done:
        raise SystemExit("ProfilerListener did not stop")
    t0 = time.perf_counter()
    rows = summarize_trace(logdir)
    summarize_s = time.perf_counter() - t0
    whole = summarize_trace(logdir, merge_fusion_names=False)
    net.set_listeners()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(PROF_STEPS + 1)]
    events[0].record()
    for i in range(PROF_STEPS):
        net.fit(ds)
        events[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    total = sum(r["total_ms"] for r in rows)
    conv = [r for r in rows if _kernel_kind(r["name"]) == "convolution"]
    out = {"trace_bytes": os.path.getsize(listener.path),
           "fit_s": fit_s, "summarize_s": summarize_s,
           "device_ms_per_step": total / PROF_STEPS,
           "step_ms_cuda_events": step_ms,
           "rows": len(rows), "top_rows": rows[:10],
           "convolution_ms_per_step": sum(r["total_ms"] for r in conv)
           / PROF_STEPS,
           "a_kernel_name_whole": whole[0]["name"],
           "a_kernel_name_merged": rows[0]["name"]}
    print(f"  trace {out['trace_bytes'] / 2 ** 20:.1f} MiB, summarized in "
          f"{summarize_s:.2f} s: {len(rows)} rows, {total:.2f} ms of device "
          f"time, {out['device_ms_per_step']:.2f} ms a step (convolutions "
          f"{out['convolution_ms_per_step']:.2f} ms); the step by CUDA "
          f"events {[round(t, 2) for t in step_ms]} ms")
    for r in rows[:8]:
        print(f"    {r['total_ms']:9.3f} ms  x{r['count']:<5d} "
              f"{r['pct']:5.2f}%  {r['name'][:90]}")
    print(f"  a whole kernel name: {whole[0]['name'][:160]}")
    if not conv or not total > 0:
        raise SystemExit("phase 29(f): no convolution kernel in the rows")
    del net
    torch.cuda.empty_cache()
    return out


def _toy_cnn(name, device, data_type):
    """Phase 29(g)'s toy copy of a classic CNN (10 classes, dropout off)."""
    from deeplearning4j_tpu_torch.models.zoo import classic_cnns as C
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    hw = CNN_TOY_HW[name]
    conf = getattr(C, f"{name}_conf")(height=hw, width=hw, channels=3,
                                      num_classes=10, data_type=data_type)
    layers = (conf.layers if hasattr(conf, "layers")
              else [v.conf for v in conf.vertices.values() if v.is_layer])
    for layer in layers:
        layer.dropout = None
    cls = ComputationGraph if name == "googlenet" else MultiLayerNetwork
    return cls(conf, device=device).init()


def _first(out):
    return out[0] if isinstance(out, list) else out


def _toy_cnn_card_vs_cpu(name):
    """One f32 forward, one f32 step and one f64 step of the toy copy on
    the card and on the CPU, the same weights."""
    import numpy as np
    hw = CNN_TOY_HW[name]
    rng = np.random.default_rng(297)
    x = rng.random((2, hw, hw, 3), dtype=np.float32)
    y = _one_hot(rng, 2, 10)
    out = {}
    with _cudnn_deterministic():
        nets = {d: _toy_cnn(name, d, "float32") for d in ("cuda", "cpu")}
        o = {d: _first(n.output(x)) for d, n in nets.items()}
        out["forward"] = _max_err(o["cuda"], o["cpu"]) / float(
            np.abs(o["cpu"]).max())
        p0 = nets["cpu"].params()
        for n in nets.values():
            n.fit(x, y)
        d_card, d_cpu = nets["cuda"].params() - p0, nets["cpu"].params() - p0
        out["f32_step_l2"] = float(np.linalg.norm(d_card - d_cpu)
                                   / np.linalg.norm(d_cpu))
        nets = {d: _toy_cnn(name, d, "float64") for d in ("cuda", "cpu")}
        p0 = nets["cpu"].params()
        for n in nets.values():
            n.fit(x.astype(np.float64), y.astype(np.float64))
        change = np.abs(nets["cpu"].params() - p0).max()
        out["f64_step"] = _max_err(nets["cuda"].params(),
                                   nets["cpu"].params()) / float(change)
    _check(f"{name} toy f32 forward, card vs CPU (of the largest output)",
           out["forward"], CNN_FWD_TOL)
    _check(f"{name} toy f32 step, parameter change (relative L2)",
           out["f32_step_l2"], CNN_F32_STEP_L2)
    _check(f"{name} toy f64 step (of the largest change)", out["f64_step"],
           CNN_F64_STEP_TOL)
    return out


def tools_classic_cnns():
    """Phase 29(g): AlexNet, VGG-16 and GoogLeNet at their published width.
    Returns their readings."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.zoo import classic_cnns as C
    print(f"phase 29(g): the classic CNNs at 224x224x3, 1000 classes, bf16, "
          f"Nesterov 0.9: one forward and {CNN_STEPS} steps each "
          f"(batches {CNN_BATCH}), then toy copies card vs CPU")
    out = {}
    for name, batch in CNN_BATCH.items():
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        net = getattr(C, name)(data_type="bfloat16")
        init_s = time.perf_counter() - t0
        # a fresh batch each step, as an epoch feeds them: VGG-16's
        # published rate (0.01, no BatchNorm) diverges on one repeated
        # batch of random labels within 4 steps, in the reference as in
        # the port (f32 on the CPU, batch 8: losses 11.4, 34.0, 1923,
        # 3.5e18, then NaN in the reference)
        gen = torch.Generator(device="cuda").manual_seed(298)
        batches = []
        for _ in range(CNN_STEPS + 3):
            x = torch.rand((batch, 224, 224, 3), generator=gen,
                           device="cuda")
            y = torch.nn.functional.one_hot(torch.randint(
                0, 1000, (batch,), generator=gen, device="cuda"),
                1000).float()
            batches.append(DataSet(x, y))
        probs = _first(net.output(batches[0].features))
        if probs.shape != (batch, 1000) or not np.isfinite(probs).all():
            raise SystemExit(f"{name}: bad output {probs.shape}")
        torch.cuda.reset_peak_memory_stats()
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(CNN_STEPS + 1)]
        scores = []
        t0 = time.perf_counter()
        events[0].record()
        for i in range(CNN_STEPS):
            net.fit(batches[i])
            scores.append(net._score)
            events[i + 1].record()
        torch.cuda.synchronize()
        first_steps_s = time.perf_counter() - t0
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        losses = [float(s) for s in scores]
        if not all(math.isfinite(v) for v in losses):
            raise SystemExit(f"{name}: losses not finite: {losses}")
        ms = _p(step_ms[1:], 50)
        r = {"batch": batch, "params": net.num_params(), "init_s": init_s,
             "losses": losses, "step_ms": step_ms, "median_step_ms": ms,
             "images_per_s": batch * 1e3 / ms,
             "steps_s_with_search": first_steps_s,
             "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "kernels": _kernel_breakdown(
                 lambda: net.fit(batches[CNN_STEPS]), iters=1, top=6)}
        # the operations of one training step, counted by torch's flop
        # counter over the step's convolutions and products (forward and
        # backward), and the least time the card takes for them
        from torch.utils.flop_counter import FlopCounterMode
        with FlopCounterMode(display=False) as counter:
            net.fit(batches[CNN_STEPS + 2])
        r["step_flop"] = counter.get_total_flops()
        r["bound_ms"] = 1e3 * r["step_flop"] / PEAK_BF16_FLOPS
        r["bound_share"] = r["bound_ms"] / ms
        print(f"  {name}: {r['params'] / 1e6:.1f}M parameters (init "
              f"{init_s:.1f} s), batch {batch}: losses "
              f"{[round(v, 4) for v in losses]}; step ms "
              f"{[round(t, 2) for t in step_ms]} (the first searches), "
              f"median of the last 3 {ms:.2f} ms, {r['images_per_s']:.0f} "
              f"images/s; peak {r['peak_memory_gib']:.2f} GiB; one traced "
              f"step {r['kernels']['device_ms']:.2f} ms of device time, "
              f"busy {r['kernels']['busy_share']:.1%}; "
              f"{r['step_flop'] / 1e12:.3f} TFLOP a step (flop counter): "
              f"bound {r['bound_ms']:.2f} ms at the bf16 peak, "
              f"{r['bound_share']:.1%} of the step")
        for k, v in r["kernels"]["top_kernels_ms"]:
            print(f"    {v:8.3f} ms  {k}")
        del net, batches, x, y
        out[name] = r
    torch.cuda.empty_cache()
    out["toy_card_vs_cpu"] = {name: _toy_cnn_card_vs_cpu(name)
                              for name in CNN_BATCH}
    return out


def tools_graft_entry():
    """Phase 29(h): graft_entry.entry()'s forward on the card."""
    import numpy as np

    from deeplearning4j_tpu_torch.graft_entry import entry
    print("phase 29(h): graft_entry.entry(): the ResNet-50 bf16 inference "
          "forward, [8, 224, 224, 3]")
    torch.cuda.empty_cache()
    fn, (params, x) = entry()
    out = fn(params, x)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: fn(params, x), iters=20)
    ok = (tuple(out.shape) == (8, 1000) and out.dtype == torch.bfloat16
          and out.is_cuda and bool(torch.isfinite(out).all()))
    sums = out.float().sum(-1).cpu().numpy()
    print(f"  output {tuple(out.shape)} {out.dtype} on {out.device}, "
          f"finite; row sums {np.round(sums, 3).tolist()}; {ms:.3f} ms a "
          f"forward by CUDA events")
    if not ok:
        raise SystemExit("phase 29(h): bad entry() output")
    return {"shape": list(out.shape), "dtype": str(out.dtype), "ms": ms}


def tools_phase(fa):
    """Phase 29. Returns its readings. The training tools, the containers'
    surface and the classic CNNs run no kernel of the port: the counters
    are set to 0 first and must read 0 after it."""
    t_phase = time.perf_counter()
    fa.reset_launches()
    out = {"sub_phase_s": {}}
    for key, fn in (("a", tools_f1), ("b", tools_listeners),
                    ("c", tools_early_stopping), ("d", tools_gradient_check),
                    ("e", tools_solvers), ("f", tools_profiler),
                    ("g", tools_classic_cnns), ("h", tools_graft_entry)):
        t = time.perf_counter()
        out[key] = fn()
        out["sub_phase_s"][key] = time.perf_counter() - t
    torch.cuda.empty_cache()
    launched = dict(fa.launches)
    if any(launched.values()):
        raise SystemExit(f"phase 29 launched flash kernels: {launched}")
    out["flash_launches"] = launched
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 29 launched no kernel of the port: {launched}; "
          f"{out['phase_s']:.1f} s ({out['sub_phase_s']})")
    return out



# Phase 30: layerwise pretraining and Keras import. (a)/(b): the MNIST deep
# autoencoder of DL4J's DeepAutoEncoderExample (Hinton & Salakhutdinov,
# Science 313:504, 2006) at its widths and batch, with RBMs and then with
# denoising AutoEncoders; (c) VaeMNIST2dPlots' VAE; 3 (a, b) and 8 (c)
# batches of the synthetic MNIST stand-in a layer.
PRE_SIZES = (1000, 500, 250, 100, 30, 100, 250, 500, 1000)
PRE_B, PRE_BATCHES = 1000, 3
VAE_B, VAE_BATCHES = 128, 8
PRE_LOGDIR = Path(__file__).resolve().parent / "build" / "phase30_prof"
PRE_TRACE_ATTEMPTS = 3


def _mnist(batch, batches, binarize=False, seed=301):
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    return MnistDataSetIterator(batch, num_examples=batch * batches,
                                seed=seed, binarize=binarize)


def _deep_autoencoder(kind, data_type="float32", device="cuda"):
    """Phase 30(a)/(b)'s network: nine pretrain layers 784-1000-500-250-
    100-30-100-250-500-1000 (RBMs, or AutoEncoders with corruption 0.3) and
    a sigmoid MSE OutputLayer 1000 -> 784; SGD, learning rate 0.1."""
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (RBM, AutoEncoder,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    b = (NeuralNetConfiguration.Builder().seed(123).updater("sgd")
         .learning_rate(0.1).activation("sigmoid").data_type(data_type)
         .list())
    for i, n in enumerate(PRE_SIZES):
        b = b.layer(i, RBM(n_out=n) if kind == "rbm"
                    else AutoEncoder(n_out=n, corruption_level=0.3))
    b = b.layer(len(PRE_SIZES), OutputLayer(n_out=784, activation="sigmoid",
                                            loss_function="mse"))
    conf = b.set_input_type(InputType.feed_forward(784)).build()
    return MultiLayerNetwork(conf, device=device).init()


def _traced(fn):
    """(device ms, wall ms, busy share) of fn() under the port's profiler
    (optimize.profiler.trace, then summarize_trace). CUPTI now and then
    hands back a window with no device event (seen once in 30(a), after
    many good ones): fn() then runs under a new trace, PRE_TRACE_ATTEMPTS
    times at most; "attempts" says how many it took."""
    from deeplearning4j_tpu_torch.optimize.profiler import (summarize_trace,
                                                            trace)
    for attempt in range(1, PRE_TRACE_ATTEMPTS + 1):
        shutil.rmtree(PRE_LOGDIR, ignore_errors=True)
        torch.cuda.synchronize()
        with trace(PRE_LOGDIR):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        try:
            rows = summarize_trace(PRE_LOGDIR)
        except RuntimeError as e:           # a trace without device events
            if attempt == PRE_TRACE_ATTEMPTS:
                raise
            print(f"  trace {attempt}: {e}; tracing again")
            continue
        device_ms = sum(r["total_ms"] for r in rows)
        return {"device_ms": device_ms, "wall_ms": wall_ms,
                "busy_share": device_ms / wall_ms, "attempts": attempt}


def _wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def pre_deep_autoencoder(kind):
    """Phase 30(a) (kind "rbm") or (b) ("autoencoder"). Returns its
    readings."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets.iterators import \
        ReconstructionDataSetIterator
    label = "(a) RBM" if kind == "rbm" else "(b) AutoEncoder"
    print(f"phase 30{label[:3]}: the MNIST deep autoencoder, {label[4:]} "
          f"stack 784-{'-'.join(map(str, PRE_SIZES))}, sigmoid MSE output "
          f"1000->784, f32, batch {PRE_B}, {PRE_BATCHES} batches a layer")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = _deep_autoencoder(kind)
    it = _mnist(PRE_B, PRE_BATCHES)
    x0 = torch.tensor(it.next_batch().features, device="cuda")
    layer0 = net.layers[0]
    with torch.no_grad():
        e0 = float(layer0.pretrain_loss(net._params[0], x0))
    first_ms = _wall_ms(lambda: net.pretrain(it))
    with torch.no_grad():
        e1 = float(layer0.pretrain_loss(net._params[0], x0))
    steps = []
    for i in range(len(PRE_SIZES)):        # warm: the second pass, timed
        ms = _wall_ms(lambda: net.pretrain_layer(i, it)) / PRE_BATCHES
        steps.append({"layer": i, "n_in": net.layers[i].n_in,
                      "n_out": net.layers[i].n_out, "ms": ms,
                      "images_per_s": PRE_B / ms * 1e3})
    _traced(lambda: net.pretrain_layer(0, it))   # CUPTI's first window
    traced = {i: _traced(lambda: net.pretrain_layer(i, it))
              for i in (0, 4)}
    pre_peak = torch.cuda.max_memory_allocated()
    rit = ReconstructionDataSetIterator(_mnist(PRE_B, PRE_BATCHES))
    ds = _mnist(PRE_B, 1, seed=302).next_batch()
    s0 = net.score((ds.features, ds.features))
    net.fit(rit)                                 # warm
    fit_ms = _wall_ms(lambda: net.fit(rit)) / PRE_BATCHES
    fit_trace = _traced(lambda: net.fit(rit))
    s1 = net.score((ds.features, ds.features))
    peak = torch.cuda.max_memory_allocated()
    finite = bool(np.isfinite(net.params()).all())
    out = {"pretrain_steps": steps, "first_pretrain_ms": first_ms,
           "layer0_pretrain_loss": [e0, e1],
           "traced_pretrain": {str(i): t for i, t in traced.items()},
           "fit_ms": fit_ms, "fit_images_per_s": PRE_B / fit_ms * 1e3,
           "fit_traced": fit_trace, "fit_score": [s0, s1],
           "pretrain_peak_bytes": pre_peak, "peak_bytes": peak}
    for r in steps:
        print(f"  pretrain layer {r['layer']} {r['n_in']}->{r['n_out']}: "
              f"{r['ms']:.3f} ms a step, {r['images_per_s']:.0f} images/s")
    for i, t in traced.items():
        print(f"  layer {i} traced: {t['device_ms']:.3f} ms of device time "
              f"in {t['wall_ms']:.3f} ms, busy {t['busy_share']:.1%} "
              f"(trace attempts {t['attempts']})")
    print(f"  layer 0's loss {e0:.4f} -> {e1:.4f} over the first pass; "
          f"fit over ReconstructionDataSetIterator {fit_ms:.3f} ms a step "
          f"({out['fit_images_per_s']:.0f} images/s), busy "
          f"{fit_trace['busy_share']:.1%} (trace attempts "
          f"{fit_trace['attempts']}); score {s0:.5f} -> {s1:.5f}; "
          f"peak {peak / 2**20:.1f} MiB (pretraining {pre_peak / 2**20:.1f})")
    if not (finite and np.isfinite([e0, e1, s0, s1]).all() and e1 < e0):
        raise SystemExit(f"phase 30{label[:3]}: bad pretraining {out}")
    del net
    return out


def pre_vae():
    """Phase 30(c): VaeMNIST2dPlots' VAE, pretrained; then
    reconstruction_probability and generate_at_mean_given_z."""
    import numpy as np

    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import \
        VariationalAutoencoder
    from deeplearning4j_tpu_torch.nn.conf.layers.variational import \
        BernoulliReconstructionDistribution
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    print(f"phase 30(c): VAE 784 -> [256, 256] -> 2 -> [256, 256], "
          f"Bernoulli, leakyrelu, RMSProp 1e-3, batch {VAE_B}, "
          f"{VAE_BATCHES} batches, pretrain only")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    conf = (NeuralNetConfiguration.Builder().seed(12345).updater("rmsprop")
            .learning_rate(1e-3).l2(1e-4).weight_init("xavier")
            .activation("leakyrelu").list()
            .layer(0, VariationalAutoencoder(
                n_out=2, encoder_layer_sizes=(256, 256),
                decoder_layer_sizes=(256, 256), pzx_activation="identity",
                reconstruction_distribution=(
                    BernoulliReconstructionDistribution())))
            .set_input_type(InputType.feed_forward(784)).build())
    net = MultiLayerNetwork(conf, device="cuda").init()
    vae = net.layers[0]
    it = _mnist(VAE_B, VAE_BATCHES, binarize=True)
    x = torch.tensor(it.next_batch().features, device="cuda")
    eps = vae.pretrain_draws(x, torch.Generator("cuda").manual_seed(31))
    with torch.no_grad():
        l0 = float(vae.pretrain_loss(net._params[0], x, draws=eps))
    first_ms = _wall_ms(lambda: net.pretrain(it))
    step_ms = _wall_ms(lambda: net.pretrain(it)) / VAE_BATCHES
    _traced(lambda: net.pretrain(it))
    tr = _traced(lambda: net.pretrain(it))
    with torch.no_grad():
        p = net._params[0]
        l1 = float(vae.pretrain_loss(p, x, draws=eps))
        logp = vae.reconstruction_probability(p, x, num_samples=16)
        logp_ms = _wall_ms(lambda: vae.reconstruction_probability(
            p, x, num_samples=16))
        g = torch.linspace(-4, 4, 20, device="cuda")
        z = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
        img = vae.generate_at_mean_given_z(p, z)
        gen_ms = _wall_ms(lambda: vae.generate_at_mean_given_z(p, z))
    peak = torch.cuda.max_memory_allocated()
    ok = (np.isfinite([l0, l1]).all() and l1 < l0
          and tuple(logp.shape) == (VAE_B,)
          and bool(torch.isfinite(logp).all()) and float(logp.max()) <= 0
          and tuple(img.shape) == (400, 784)
          and bool(((img >= 0) & (img <= 1)).all()))
    out = {"step_ms": step_ms, "images_per_s": VAE_B / step_ms * 1e3,
           "first_pretrain_ms": first_ms, "elbo_loss": [l0, l1],
           "traced": tr, "reconstruction_probability_ms": logp_ms,
           "mean_log_p": float(logp.mean()), "generate_ms": gen_ms,
           "peak_bytes": peak}
    print(f"  {step_ms:.3f} ms a pretrain step ({out['images_per_s']:.0f} "
          f"images/s), busy {tr['busy_share']:.1%} (trace attempts "
          f"{tr['attempts']}); negative ELBO on a "
          f"fixed batch and eps {l0:.3f} -> {l1:.3f}; "
          f"reconstruction_probability x16 {logp_ms:.3f} ms (mean log p "
          f"{out['mean_log_p']:.2f}); generate_at_mean_given_z on a 20x20 "
          f"grid {gen_ms:.3f} ms; peak {peak / 2**20:.1f} MiB")
    if not ok:
        raise SystemExit(f"phase 30(c): bad VAE {out}")
    del net
    return out


def pre_keras():
    """Phase 30(d): the Keras import, from the npz form of the committed
    fixture and from tier-1's model builders (the card's machine has no
    h5py), card against Keras's predictions and against the CPU."""
    import numpy as np
    print("phase 30(d): Keras import: the real fixture from its npz against "
          "Keras's predictions; Keras 1 MLP, th conv, LSTM and functional "
          "nets card against CPU (f32)")
    K = _load_tier1("test_torch_keras_import")
    net = K.build(*K.read_npz_model(), device="cuda")
    io = np.load(K.REAL_IO)
    err_keras = float(np.abs(K._first(net.output(io["x"])) - io["y"]).max())
    inputs = {"mlp": (5, 4), "th_conv": (2, 8, 8, 2), "lstm": (2, 6, 3),
              "functional": (3, 6, 6, 2)}
    errs = {}
    rng = np.random.default_rng(303)
    for name, shape in inputs.items():
        cfg, w = K.MODELS[name]()
        x = rng.standard_normal(shape).astype(np.float32)
        a, b = (K._first(K.build(cfg, K.groups(w), d).output(x))
                for d in ("cuda", "cpu"))
        errs[name] = float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
    print(f"  real fixture on the card vs Keras: {err_keras:.3e} (limit "
          f"1e-5); card vs CPU: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (limit 1e-5)")
    if not (err_keras <= 1e-5 and all(v <= 1e-5 for v in errs.values())):
        raise SystemExit("phase 30(d): Keras import disagrees")
    return {"real_fixture_vs_keras": err_keras, "card_vs_cpu": errs}


def _same_draws(net, seed):
    """Make each pretrain layer of `net` draw on the CPU from its own
    generator and move the draws to the batch's device, so that a card
    network and a CPU network get the same draws."""
    def moved(d, device):
        if d is None or isinstance(d, torch.Tensor):
            return None if d is None else d.to(device)
        return [t.to(device) for t in d]

    for i, layer in enumerate(net.layers):
        if hasattr(layer, "pretrain_draws"):
            orig = layer.pretrain_draws
            gen = torch.Generator().manual_seed(seed + i)
            layer.pretrain_draws = (
                lambda h, g, orig=orig, gen=gen:
                moved(orig(h.cpu(), gen), h.device))


def pre_card_vs_cpu():
    """Phase 30, card against CPU in float64 with the same draws: CD-1, a
    gaussian CD-2, an AutoEncoder and a VAE pretrained over 3 batches."""
    import numpy as np

    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        RBM, AutoEncoder, OutputLayer, VariationalAutoencoder)
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    print("phase 30: card vs CPU, float64, the same draws: RBM 784->1000 "
          "(CD-1), RBM 1000->500 (gaussian hidden, CD-2), AutoEncoder "
          "500->250, VAE 250->[256, 256]->2, batch 100, 3 batches each")

    def make(device):
        conf = (NeuralNetConfiguration.Builder().seed(7).updater("adam")
                .learning_rate(1e-3).activation("sigmoid")
                .data_type("float64").list()
                .layer(0, RBM(n_out=1000))
                .layer(1, RBM(n_out=500, k=2, hidden_unit="gaussian"))
                .layer(2, AutoEncoder(n_out=250, corruption_level=0.3))
                .layer(3, VariationalAutoencoder(
                    n_out=2, encoder_layer_sizes=(256, 256),
                    decoder_layer_sizes=(256, 256), activation="tanh"))
                .layer(4, OutputLayer(n_out=10, activation="softmax"))
                .set_input_type(InputType.feed_forward(784)).build())
        net = MultiLayerNetwork(conf, device=device).init()
        _same_draws(net, 3000)
        return net

    nets = {d: make(d) for d in ("cuda", "cpu")}
    scores = {}
    for d, net in nets.items():
        net.pretrain(_mnist(100, 3, binarize=True, seed=304))
        scores[d] = net.score()
    a, b = nets["cuda"].params(), nets["cpu"].params()
    err = float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
    moved = float(np.abs(b - make("cpu").params()).max())
    serr = abs(scores["cuda"] - scores["cpu"]) / max(1.0, abs(scores["cpu"]))
    print(f"  parameters {err:.3e}, last score {serr:.3e} (limit 1e-9); "
          f"pretraining moved the parameters by up to {moved:.3e}")
    if not (err <= 1e-9 and serr <= 1e-9 and moved > 0):
        raise SystemExit("phase 30: card and CPU pretraining disagree")
    return {"params_err": err, "score_err": serr, "moved": moved}


def pretrain_phase(fa):
    """Phase 30. Returns its readings. Pretraining and the Keras import run
    no kernel of the port: the counters are set to 0 first and must read 0
    after it."""
    t_phase = time.perf_counter()
    fa.reset_launches()
    out = {"sub_phase_s": {}}
    for key, fn in (("a", lambda: pre_deep_autoencoder("rbm")),
                    ("b", lambda: pre_deep_autoencoder("autoencoder")),
                    ("c", pre_vae), ("d", pre_keras),
                    ("card_vs_cpu", pre_card_vs_cpu)):
        t = time.perf_counter()
        out[key] = fn()
        out["sub_phase_s"][key] = time.perf_counter() - t
    torch.cuda.empty_cache()
    launched = dict(fa.launches)
    if any(launched.values()):
        raise SystemExit(f"phase 30 launched flash kernels: {launched}")
    out["flash_launches"] = launched
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 30 launched no kernel of the port: {launched}; "
          f"{out['phase_s']:.1f} s ({out['sub_phase_s']})")
    return out


# -- phase 31: model parallelism --------------------------------------------

MP_WORLD = 4
MP_GROUP_TIMEOUT_S, MP_JOIN_TIMEOUT_S = 120, 400
MP_SEED = 310
MP_M = 4                    # (a): microbatches of one row each
MP_MOE = dict(d=512, e=8, f=2048, tokens=4096)
# (a), bf16: the pipeline runs the sequential model's kernels on one row a
# microbatch (cuBLAS picks its products by shape) and sums each stage's
# weight gradient over 7 ticks in bf16 where the sequential backward sums
# one product; each such sum rounds to 2^-8 relative. The limits: the
# loss 5e-3 relative, each stage gradient 2e-2 relative L2.
MP_LOSS_RTOL, MP_GRAD_RL2 = 5e-3, 2e-2
# (b), bf16: the Megatron block rounds each rank's partial product (the
# attention's output projection, the MLP's down-projection) to bf16 before
# the all-reduce adds them, where the dense block rounds one whole product:
# one more rounding on the block's two outputs and on every gradient that
# flows back through them. Read 1.2e-2 in the CPU rehearsal at d 64.
MP_TP_GRAD_RL2 = 5e-2


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _rel_max(a, b):
    """max |a - b| over max(1, max |b|): f32 products summed in another
    order."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def _mp_tokens(t, seed):
    import numpy as np
    x = np.random.default_rng(seed).integers(0, FULL["vocab_size"],
                                              (B, t)).astype(np.int64)
    return x, (x + 1) % FULL["vocab_size"]


def _mp_lm(dtype, device):
    """(aux, 4 blocks) at bench.py's width, from MP_SEED (a CPU generator:
    the same weights in every process)."""
    from deeplearning4j_tpu_torch.models.zoo import transformer as TR
    return TR.init_lm(FULL["vocab_size"], FULL["d_model"], FULL["n_heads"],
                      4, max_len=T, seed=MP_SEED, dtype=dtype,
                      device=device)


def _mp_pipeline(dtype, device, group=None, attention="flash"):
    from deeplearning4j_tpu_torch.models.zoo import transformer as TR
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        PipelineParallel, make_pipeline_mesh)
    aux, blocks = _mp_lm(dtype, device)
    return PipelineParallel(
        TR.make_block_fn(FULL["n_heads"], attention), blocks,
        make_pipeline_mesh(MP_WORLD, group=group, device=device),
        loss_fn=TR.lm_loss,
        aux_params=aux, pre_fn=TR.embed_fn, n_micro=MP_M,
        learning_rate=0.1, momentum=0.9)


def _mp_gpipe(rank, fa, barrier, cpu_group=None):
    """31(a) on this rank: stage 'rank' of four, bf16, T=8192. `barrier`
    waits for every rank; `cpu_group` carries the f32 CPU pipeline (None:
    the world group, a gloo one)."""
    from deeplearning4j_tpu_torch.parallel import ring_attention as ra
    out = {}
    pp = _mp_pipeline(torch.bfloat16, "cuda")
    x, y = _mp_tokens(T, MP_SEED + 1)
    xs, ys = pp._put_micro(x), pp._put_micro(y)
    loss = pp._loss(xs, ys)
    grads = torch.autograd.grad(loss, list(pp.stage.parameters()))
    out["grad_loss"] = float(loss.detach())
    out["stage_grads"] = {n: g.float().cpu() for (n, _), g in
                          zip(pp.stage.named_parameters(), grads)}
    del loss, grads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, step_ms = [], []
    for _ in range(3):
        barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(pp.fit_batch(x, y))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    out["launches_fit"] = dict(fa.launches)
    # one more step under the port's profiler: this rank's device time
    # beside the step's wall time (the four ranks share the card)
    from deeplearning4j_tpu_torch.optimize.profiler import (summarize_trace,
                                                            trace)
    logdir = str(Path(__file__).resolve().parent / "build"
                 / f"mp_trace_{os.getpid()}")
    barrier()
    with trace(logdir):
        t0 = time.perf_counter()
        pp.fit_batch(x, y)
        torch.cuda.synchronize()
        out["traced_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    out["traced_device_ms"] = sum(r["total_ms"]
                                  for r in summarize_trace(logdir))
    shutil.rmtree(logdir, ignore_errors=True)
    # one more step with each rotation timed on the host clock, the card
    # synchronised before and after it: a span holds the rotation's
    # staging through the host and its wait for the peer rank, not this
    # rank's queued compute
    spans, rotate = [], ra._ppermute

    def timed_rotation(tensors, group, shift=1):
        torch.cuda.synchronize()
        t_r = time.perf_counter()
        moved = rotate(tensors, group, shift)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t_r)
        return moved

    ra._ppermute = timed_rotation
    try:
        barrier()
        t0 = time.perf_counter()
        pp.fit_batch(x, y)
        torch.cuda.synchronize()
        out["timed_rotations_step_ms"] = 1e3 * (time.perf_counter() - t0)
    finally:
        ra._ppermute = rotate
    out["rotations_in_step"] = len(spans)
    out["rotation_spans_ms"] = 1e3 * sum(spans)
    fa.reset_launches()
    barrier()
    t0 = time.perf_counter()
    h = pp.forward(x)
    torch.cuda.synchronize()
    out["forward_ms"] = 1e3 * (time.perf_counter() - t0)
    out["launches_forward"] = dict(fa.launches)
    out["forward_ok"] = (tuple(h.shape) == (B, T, FULL["d_model"])
                         and bool(torch.isfinite(h).all()))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["losses"], out["step_ms"] = losses, step_ms
    act = torch.randn(1, T, FULL["d_model"], device="cuda",
                      dtype=torch.bfloat16)
    group = pp.mesh.axis_group("pipe")
    barrier()
    out["rotation_ms"] = cuda_ms(lambda: ra._ppermute([act], group),
                                 iters=5, warmup=1)
    del pp, h, act
    torch.cuda.empty_cache()
    # f32, T=1024: the kernels on the card against the plain versions on
    # the CPU, through the same schedule; one step (the CPU's part is the
    # slow one)
    x1, y1 = x[:, :1024], y[:, :1024]
    runs = []
    for dev, group in (("cuda", None), ("cpu", cpu_group)):
        p32 = _mp_pipeline(torch.float32, dev, group)
        ls = [p32.fit_batch(x1, y1)]
        runs.append((ls, [p.detach().cpu() for p in p32._params()]))
        del p32
    out["f32_loss_err"] = max(abs(a - b) for a, b in zip(runs[0][0],
                                                         runs[1][0]))
    out["f32_param_err"] = max((a - b).abs().max().item()
                               for a, b in zip(runs[0][1], runs[1][1]))
    return out


def _mp_three_axis(rank):
    """31(b): Megatron blocks in the GPipe rotation on (data 1, model 2,
    pipe 2), T=1024, f32 and bf16, against the dense blocks run in order
    on this rank; then 10 bf16 steps."""
    from deeplearning4j_tpu_torch.models.zoo import transformer as TR
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        PipelineParallel, make_pipeline_mesh)
    from deeplearning4j_tpu_torch.parallel.sharding import shard_slice
    mesh = make_pipeline_mesh(2, n_data=1, n_model=2, device="cuda")
    s, m = mesh.index("pipe"), mesh.index("model")
    H, d = FULL["n_heads"], FULL["d_model"]
    specs = TR.tp_block_specs()
    x, y = _mp_tokens(1024, MP_SEED + 2)
    x, y = x[:2], y[:2]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(MP_SEED + 3)
        dense = [TR.init_block(gen, d, H, 4 * d, dtype, "cuda")
                 for _ in range(2)]
        aux = TR.init_lm(FULL["vocab_size"], d, H, 1, max_len=1024,
                         seed=MP_SEED + 4, dtype=dtype, device="cuda")[0]
        pp = PipelineParallel(
            TR.make_tp_block_fn(H // 2, mesh=mesh),
            [TR.tp_block_from_block(b, H) for b in dense], mesh,
            loss_fn=TR.lm_loss, aux_params=aux, pre_fn=TR.embed_fn,
            n_micro=2, learning_rate=0.1, momentum=0.9, param_specs=specs)
        xs, ys = pp._put_micro(x), pp._put_micro(y)
        loss = pp._loss(xs, ys)
        names = [n for n, _ in pp.stage.named_parameters()]
        g = torch.autograd.grad(loss, list(pp.stage.parameters()))
        # the dense blocks in order, on this rank alone
        blk = TR.make_block_fn(H)
        xt, yt = (torch.as_tensor(a, device="cuda") for a in (x, y))
        h = TR.embed_fn(aux, xt)
        for b in dense:
            h = blk(b, h)
        seq = TR.lm_loss(aux, h, yt)
        sg = torch.autograd.grad(seq, list(dense[s].parameters()))
        want = TR.tp_layout(dict(zip(
            [n for n, _ in dense[s].named_parameters()], sg)), H)
        errs = {}
        for n, gt in zip(names, g):
            w = want[n]
            for dim, ax in enumerate(specs[n][1:]):
                if ax == "model":
                    w = shard_slice(w, dim, m, 2)
            errs[n] = (_rel_max(gt, w) if dtype == torch.float32
                       else _rel_l2(gt.float(), w.float()))
        key = "f32" if dtype == torch.float32 else "bf16"
        out[key] = {"loss": float(loss.detach()),
                    "seq_loss": float(seq.detach()),
                    "grad_err": max(errs.values()),
                    "local_wqkv": tuple(pp.stage.attn.wqkv.shape)}
        if dtype == torch.bfloat16:
            out["losses"] = [pp.fit_batch(x, y) for _ in range(10)]
    return out


def _mp_moe(rank):
    """31(c): experts over 4 ranks (two a rank) against the dense layer on
    this rank, f32: k=1, 2, with and without a capacity that drops; dp x
    ep top-2; one step of a MoE block."""
    import copy

    from deeplearning4j_tpu_torch.models.zoo import transformer as TR
    from deeplearning4j_tpu_torch.parallel import moe
    c = MP_MOE
    gen = torch.Generator().manual_seed(MP_SEED + 5)
    full = moe.init_moe(gen, c["d"], c["e"], c["f"], device="cuda")
    with torch.no_grad():       # non-zero biases, the same on every rank
        for b in (full.b1, full.b2):
            b.copy_(0.1 * torch.randn(b.shape, generator=gen))
    x = torch.randn(c["tokens"], c["d"], generator=gen).cuda()
    w = torch.randn(c["tokens"], c["d"], generator=gen).cuda()
    names = ["gate", "w1", "b1", "w2", "b2"]
    out = {"cases": {}}

    def case(mesh, params, k, cap, data_axis=None):
        local = moe.shard_moe_params(params, mesh)
        apply = moe.moe_mlp_sharded(mesh, capacity=cap, k=k,
                                    data_axis=data_axis)
        xg = x.clone().requires_grad_()
        yv, aux = apply(local, xg)
        g = torch.autograd.grad((yv * w).sum() + aux,
                                [getattr(local, n) for n in names] + [xg])
        dp = copy.deepcopy(params)
        xd = x.clone().requires_grad_()
        n_sh = mesh.n_ranks
        yd, auxd = moe.moe_mlp_dense(dp, xd, cap, n_sh, k)
        gd = torch.autograd.grad((yd * w).sum() + auxd,
                                 [getattr(dp, n) for n in names] + [xd])
        e = mesh.index("expert")
        per = params.w1.shape[0] // mesh.axis_size("expert")
        errs = {"y": _rel_max(yv, yd),
                "aux": abs(float(aux.detach()) - float(auxd.detach()))}
        for n, a, b in zip(names + ["x"], g, gd):
            errs[n] = _rel_max(a, b if n in ("gate", "x")
                               else b[e * per:(e + 1) * per])
        shard = (mesh.index("data") * mesh.axis_size("expert") + e
                 if data_axis else e)
        rows = slice(shard * c["tokens"] // n_sh,
                     (shard + 1) * c["tokens"] // n_sh)
        ids_local = moe._route_topk(params.gate, x[rows], k)[0]
        ids_dense = moe._route_topk(params.gate, x, k)[0][rows]
        with torch.no_grad():
            ms = cuda_ms(lambda: apply(local, x), iters=3, warmup=1)
        return {"errs": errs, "ids_equal": bool(torch.equal(ids_local,
                                                            ids_dense)),
                "y": yd.detach(), "sharded_ms": ms}

    mesh = moe.make_expert_mesh(MP_WORLD, device="cuda")
    ys = {}
    # a capacity of 3/4 of an expert's mean load drops units
    caps = {k: 3 * (k * c["tokens"] // MP_WORLD) // (4 * c["e"])
            for k in (1, 2)}
    for k, cap in ((1, None), (1, caps[1]), (2, None), (2, caps[2])):
        r = case(mesh, full, k, cap)
        ys[(k, cap)] = r.pop("y")
        out["cases"][f"k{k}_cap{cap}"] = r
    out["drops"] = {k: float((ys[(k, caps[k])] - ys[(k, None)]).abs().max())
                    for k in (1, 2)}
    de_mesh = moe.make_expert_mesh(2, n_data=2, device="cuda")
    half = moe.init_moe(torch.Generator().manual_seed(MP_SEED + 6), c["d"],
                        4, c["f"], device="cuda")
    r = case(de_mesh, half, 2, None, "data")
    r.pop("y")
    out["cases"]["dp_ep_k2"] = r
    # one SGD step of a MoE block, sharded experts against dense ones
    blk = TR.init_moe_block(torch.Generator().manual_seed(MP_SEED + 7),
                            c["d"], FULL["n_heads"], c["e"], c["f"],
                            device="cuda")
    sb = copy.deepcopy(blk)
    sb.moe = moe.shard_moe_params(blk.moe, mesh)
    xb = x.reshape(4, c["tokens"] // 4, c["d"])
    wb = w.reshape(xb.shape)
    grads = []
    for b, fn in ((blk, TR.make_moe_block_fn(FULL["n_heads"],
                                              moe.moe_mlp_dense)),
                  (sb, TR.make_moe_block_fn(FULL["n_heads"],
                                            moe.moe_mlp_sharded(mesh)))):
        yb, aux = fn(b, xb)
        ps = list(b.parameters())
        gs = torch.autograd.grad((yb * wb).sum() + aux, ps)
        grads.append(dict(zip([n for n, _ in b.named_parameters()], gs)))
        with torch.no_grad():               # the SGD step
            for p_, g_ in zip(ps, gs):
                p_ -= 1e-4 * g_
    e = mesh.index("expert")
    dense_g, shard_g = grads
    out["block_err"] = max(
        _rel_max(g_, dense_g[n] if not n.startswith("moe.")
                 or n == "moe.gate" else dense_g[n][2 * e:2 * e + 2])
        for n, g_ in shard_g.items())
    return out


def _mp_wrapper(rank, out_dir):
    """31(d): LeNet with Adam, global batch 128, on (data 2, model 2) with
    tensor parallelism and the sharded updater state, against the
    replicated run on the same 4 ranks; a sharded-run checkpoint restored
    into a fresh 4-rank layout."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.sharding import make_mesh
    from deeplearning4j_tpu_torch.util.sharded_checkpoint import \
        ShardedCheckpointManager
    batches = _lenet_data(MP_SEED + 8, 128, 3)

    def build(nm, split):
        net = lenet(device="cuda", updater="adam", learning_rate=1e-3)
        pw = (ParallelWrapper.Builder(net)
              .mesh(make_mesh(n_data=MP_WORLD // nm, n_model=nm,
                              device="cuda"))
              .tensor_parallel(split).sharded_updater_state(split).build())
        return net, pw

    def shapes(net):
        return ({f"{k}.{n}": tuple(p.shape) for k, per in
                 net._params.items() for n, p in per.items()},
                {f"{k}.{n}.{s}": tuple(t.shape) for k, per in
                 net._updater_state.items() for n, st in per.items()
                 for s, t in st.items()})

    out = {}
    with _cudnn_deterministic():
        net, pw = build(2, True)
        whole = shapes(net)
        pw._ensure_sharded()
        local = shapes(net)
        pw._join_state()
        pw.fit(ListDataSetIterator(batches))
        rep, rpw = build(1, False)
        rpw.fit(ListDataSetIterator(batches))
        out["param_err"] = float(np.abs(net.params() - rep.params()).max())
        out["lowered"] = pw.lower_step(batches[0]).footprint
        # each rank's FLOPs in one step (lower_step puts everything back):
        # split on (data 2, model 2), data parallel on (data 4), and
        # replicated on (data 2, model 2), each rank the same 64 rows whole
        from torch.utils.flop_counter import FlopCounterMode
        flops = {}
        for key, run in (("tp_zero", pw), ("data_parallel", rpw),
                         ("replicated_same_rows", build(2, False)[1])):
            with FlopCounterMode(display=False) as fc:
                run.lower_step(batches[0])
            flops[key] = int(fc.get_total_flops())
        out["flops"] = flops
    # a parameter that divides keeps 1/2 (over "model"); an updater state
    # leaf 1/2 (over "data") or, when its parameter is split too, 1/4
    split = {"params_half": 0, "state_half": 0, "state_quarter": 0,
             "other": 0}
    for i, kind in ((0, "params"), (1, "state")):
        for key, w_ in whole[i].items():
            l_ = local[i][key]
            if w_ == l_:
                continue
            r_ = int(np.prod(w_)) / int(np.prod(l_))
            name = f"{kind}_{'half' if r_ == 2 else 'quarter'}"
            split[name if name in split else "other"] += 1
    out["split"] = split
    # saved while split: every rank writes its shards (a directory), then
    # restored into a fresh split layout on the 4 ranks
    ck = Path(out_dir) / "ckpt"
    mgr = ShardedCheckpointManager(str(ck))
    pw._ensure_sharded()
    mgr.save(net, 3)
    pw._join_state()
    out["sharded_dir"] = (ck / "ckpt_3").is_dir()
    fresh, fpw = build(2, True)
    fpw._ensure_sharded()
    mgr.restore(fresh, 3)
    fpw._join_state()
    out["restore_equal"] = bool(np.array_equal(fresh.params(), net.params()))
    out["params"] = net.params()
    out["ckpt"] = str(ck)
    # the step time of TP + ZeRO on (data 2, model 2) against plain data
    # parallelism on (data 4): fits of the 3 batches, each timed twice in
    # turn (the state split and joined at each fit's ends), the least
    import torch.distributed as dist
    # and this rank's peak device memory over each such fit
    times = {"tp_zero": [], "data_parallel": []}
    peak = {"tp_zero": 0, "data_parallel": 0}
    for _ in range(2):
        for key, run in (("tp_zero", pw), ("data_parallel", rpw)):
            dist.barrier()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run.fit(ListDataSetIterator(batches))
            torch.cuda.synchronize()
            times[key].append(1e3 * (time.perf_counter() - t0)
                              / len(batches))
            peak[key] = max(peak[key], torch.cuda.max_memory_allocated())
    out["step_ms"] = {key: min(v) for key, v in times.items()}
    out["peak_mib"] = {key: v / 2 ** 20 for key, v in peak.items()}
    return out


def _mp_w2v(rank):
    """31(e): config 4's skip-gram (V=10,000, D=100, negative 5) with syn0
    and syn1neg column-sharded over the 4 ranks (25 columns each, eager:
    each 64-pair chunk's logits all-reduced through the host) against the
    same learner whole on this rank (CUDA graphs), 3 flushes of 4,096
    pairs, f32."""
    import numpy as np

    from deeplearning4j_tpu_torch.parallel.sharding import make_mesh
    vocab = _emb_vocab()
    rng = np.random.default_rng(MP_SEED + 10)
    pairs = [(rng.integers(0, EMB_V, 4096), rng.integers(0, EMB_V, 4096))
             for _ in range(3)]
    out = {}
    for name, mesh in (("sharded", make_mesh(n_data=1, n_model=MP_WORLD,
                                             device="cuda")),
                       ("whole", None)):
        learner = _emb_learner(vocab, "skipgram", False, 4096, "cuda")
        if mesh is not None:
            learner.configure(vocab, learner.lookup, window=EMB_WINDOW,
                              negative=EMB_NEG, use_hs=False, seed=1,
                              mesh=mesh, device="cuda")
            out["local_d"] = int(learner._syn0.shape[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c, o in pairs:
            learner.enqueue_pairs(c, o, 0.025)
        learner.finish()
        torch.cuda.synchronize()
        out[f"{name}_ms_per_flush"] = 1e3 * (time.perf_counter() - t0) / 3
        out[name] = (learner.lookup.syn0.copy(),
                     learner.lookup.syn1neg.copy())
    out["err"] = max(float(np.abs(a - b).max()) for a, b in
                     zip(out.pop("sharded"), out.pop("whole")))
    return out


def mp_rank(rank, world, store, out_dir, backend="gloo"):
    """One rank of phase 31, started by spawn: on cuda:0 in a gloo group,
    (a) through (e), the flash counters set to 0 after (a) and read after
    (e); over NCCL (one rank a card), (a) alone, its f32 CPU pipeline on a
    gloo group beside."""
    import torch.distributed as dist
    import traceback

    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    code = 1
    try:
        nccl = backend == "nccl"
        torch.cuda.set_device(rank if nccl else 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_num_threads(2)
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world,
            timeout=timedelta(seconds=MP_GROUP_TIMEOUT_S))
        barrier = (partial(dist.barrier, device_ids=[rank]) if nccl
                   else dist.barrier)
        cpu_group = dist.new_group(backend="gloo") if nccl else None
        res = {"sub_phase_s": {}}
        parts = [("a", lambda r: _mp_gpipe(r, fa, barrier, cpu_group))]
        if not nccl:
            parts += [("b", _mp_three_axis), ("c", _mp_moe),
                      ("d", lambda r: _mp_wrapper(r, out_dir)),
                      ("e", _mp_w2v)]
        for key, fn in parts:
            t = time.perf_counter()
            res[key] = fn(rank)
            res["sub_phase_s"][key] = time.perf_counter() - t
            if key == "a":
                fa.reset_launches()
            # a hang shows in the log as the part after the last line
            print(f"  31({key}) rank {rank} done in "
                  f"{res['sub_phase_s'][key]:.1f} s", flush=True)
        res["flash_after_bcde"] = dict(fa.launches) if not nccl else {}
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
        code = 0
    except BaseException:
        traceback.print_exc()
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        # the meshes hold gloo subgroups: leave without their teardown
        os._exit(code)


def _mp_run_ranks(backend="gloo"):
    import torch.multiprocessing as mp
    work = (Path(__file__).resolve().parent / "build"
            / f"mp_{backend}_{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=mp_rank, args=(
        r, MP_WORLD, str(work / "store"), str(work), backend))
        for r in range(MP_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MP_JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * MP_WORLD:
        raise SystemExit(f"phase 31 ranks over {backend} exited {codes}")
    return work, [torch.load(work / f"rank{r}.pt", weights_only=False)
                  for r in range(MP_WORLD)]


def _mp_sequential_grads():
    """The four blocks in order in this process, through the same kernels
    (bf16, T=8192, one backward): (loss, [each block's gradients])."""
    from deeplearning4j_tpu_torch.models.zoo import transformer as TR
    aux, blocks = _mp_lm(torch.bfloat16, "cuda")
    lm = TR.TransformerLM.__new__(TR.TransformerLM)
    torch.nn.Module.__init__(lm)
    lm._setup(aux, blocks, FULL["n_heads"], "flash", 0.1, 0.9)
    x, y = _mp_tokens(T, MP_SEED + 1)
    xt, yt = (torch.as_tensor(a, device="cuda") for a in (x, y))
    loss = lm._loss(xt, yt)
    grads = []
    for b in lm.blocks:
        names = [n for n, _ in b.named_parameters()]
        grads.append(names)
    flat = torch.autograd.grad(loss, [p for b in lm.blocks
                                      for p in b.parameters()])
    it = iter(flat)
    out = [{n: next(it).float().cpu() for n in names} for names in grads]
    return float(loss.detach()), out


def _mp_stage_timings(fa):
    """K1, K2, K4, K5 at the pipeline's stage shape (B=1, T=8192, H=8,
    D=64, bf16, causal): first each against its plain version on the same
    inputs, with phases 3 and 7's bf16 limits (a SystemExit on a
    mismatch), then timed by CUDA events beside each one's bound."""
    H, D = FULL["n_heads"], FULL["d_model"] // FULL["n_heads"]
    shape = f"B=1 T={T} H={H} D={D} bf16 causal"
    args, errs = check_training_kernels(
        fa, f"stage shape {shape}", 1, T, H, D, torch.bfloat16, True,
        (1e-2, 1e-2, 1e-2), seed=31)
    q, k, v, do, lse, delta = args
    errs["fwd"] = check_flash(fa, f"K1 stage shape {shape}", q, k, v, True,
                              None, atol=1e-2, rtol=1e-2, row_rtol=1e-2)
    pairs = H * T * (T + 1) / 2
    panel = T * H * D * 2
    stats = H * T * 4
    calls = {
        "fwd": (lambda: fa.flash_attention(q, k, v, True),
                4 * D * pairs, 4 * panel),
        "fwd_lse": (lambda: fa.flash_attention_fwd_lse(q, k, v, True),
                    4 * D * pairs, 4 * panel + stats),
        "bwd_dq": (lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse,
                                                     delta, True),
                   6 * D * pairs, 5 * panel + 2 * stats),
        "bwd_dkv": (lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                       delta, True),
                    8 * D * pairs, 6 * panel + 2 * stats)}
    out = {}
    with torch.no_grad():
        for name, (fn, flops, nbytes) in calls.items():
            ms = cuda_ms(fn, iters=20)
            b_ms, b_by = bound(flops, nbytes)
            out[name] = {"max_abs_err": errs[name], "ms": ms,
                         "bound_ms": b_ms, "bound_by": b_by, "shape": shape}
    return out


def _mp_check_gpipe(ranks, seq_loss, seq_grads, backend):
    """31(a)'s checks over the ranks' readings; returns its summary."""
    S = MP_WORLD
    ticks = MP_M + S - 1
    want_fit = {"fwd": 0, "fwd_lse": 3 * ticks, "partial": 0,
                "bwd_dq": 3 * ticks, "bwd_dkv": 3 * ticks}
    want_fwd = {"fwd": ticks, "fwd_lse": 0, "partial": 0, "bwd_dq": 0,
                "bwd_dkv": 0}
    grad_err, loss_err = 0.0, 0.0
    for r, res in enumerate(ranks):
        a = res["a"]
        if a["launches_fit"] != want_fit or a["launches_forward"] != \
                want_fwd:
            raise SystemExit(f"31(a) rank {r} launched {a['launches_fit']} "
                             f"in 3 fit_batch steps and "
                             f"{a['launches_forward']} in forward: want "
                             f"{want_fit} and {want_fwd}")
        if not a["forward_ok"]:
            raise SystemExit(f"31(a) rank {r}: bad forward")
        loss_err = max(loss_err, abs(a["grad_loss"] - seq_loss) / seq_loss)
        for n, g in a["stage_grads"].items():
            grad_err = max(grad_err, _rel_l2(g, seq_grads[r][n]))
        if not (a["f32_loss_err"] <= 1e-5 and a["f32_param_err"] <= 1e-5):
            raise SystemExit(f"31(a) rank {r}: f32 T=1024 card vs CPU "
                             f"{a['f32_loss_err']:.3e} / "
                             f"{a['f32_param_err']:.3e}")
        if not (all(map(math.isfinite, a["losses"]))
                and a["losses"] == ranks[0]["a"]["losses"]):
            raise SystemExit(f"31(a) rank {r} losses {a['losses']}")
    a0 = ranks[0]["a"]
    step_ms = max(max(res["a"]["step_ms"][1:]) for res in ranks)
    rot_ms = max(res["a"]["rotation_ms"] for res in ranks)
    rotations = 2 * ticks - 1
    device_ms = [res["a"]["traced_device_ms"] for res in ranks]
    # measured: each rank's rotation spans over its instrumented step
    span_share = [res["a"]["rotation_spans_ms"]
                  / res["a"]["timed_rotations_step_ms"] for res in ranks]
    traced_wall = max(res["a"]["traced_wall_ms"] for res in ranks)
    # gloo: the ranks share one card; NCCL: each rank has its own
    cards = 1 if backend == "gloo" else len(ranks)
    out = {"launches_fit_per_rank": a0["launches_fit"],
           "launches_forward_per_rank": a0["launches_forward"],
           "loss_rel_err": loss_err, "grad_rel_l2": grad_err,
           "losses": a0["losses"],
           "step_ms": [max(res["a"]["step_ms"][i] for res in ranks)
                       for i in range(3)],
           "tokens_per_s": B * T / step_ms * 1e3,
           "rotation_ms": rot_ms, "rotations_per_step": rotations,
           "rotation_share_estimate": rotations * rot_ms / step_ms,
           "rotations_counted": [res["a"]["rotations_in_step"]
                                 for res in ranks],
           "rotation_spans_ms": [res["a"]["rotation_spans_ms"]
                                 for res in ranks],
           "timed_rotations_step_ms": [res["a"]["timed_rotations_step_ms"]
                                       for res in ranks],
           "rotation_span_share": span_share,
           "traced_device_ms_per_rank": device_ms,
           "card_busy_share": sum(device_ms) / (cards * traced_wall),
           "forward_ms": a0["forward_ms"],
           "peak_gib": [res["a"]["peak_gib"] for res in ranks],
           "f32_loss_err": max(res["a"]["f32_loss_err"] for res in ranks),
           "f32_param_err": max(res["a"]["f32_param_err"]
                                for res in ranks)}
    out["backend"] = backend
    print(f"  31(a) GPipe over {backend}, 4 flash stages, bf16 T={T}, "
          f"M={MP_M}: launches "
          f"per rank {a0['launches_fit']} over 3 steps, "
          f"{a0['launches_forward']} per forward; loss vs sequential "
          f"{loss_err:.3e} (<= {MP_LOSS_RTOL}), stage gradients rel L2 "
          f"{grad_err:.3e} (<= {MP_GRAD_RL2}); step "
          f"{out['step_ms']} ms, {out['tokens_per_s']:.0f} "
          f"tokens/s; rotations measured in an instrumented step: "
          f"{out['rotations_counted']} a rank, their spans "
          f"{[round(m, 2) for m in out['rotation_spans_ms']]} ms of "
          f"{[round(m, 1) for m in out['timed_rotations_step_ms']]} ms = "
          f"{[round(f, 3) for f in span_share]} (host staging and the wait "
          f"for the peer); estimate from a lone rotation {rot_ms:.2f} ms x "
          f"{rotations} = {out['rotation_share_estimate']:.1%} of a step; "
          f"busy "
          f"{out['card_busy_share']:.1%} a card (a traced step, the ranks' "
          f"device ms {[round(m, 1) for m in device_ms]}); peak "
          f"{[round(g, 2) for g in out['peak_gib']]} GiB; f32 T=1024 "
          f"card vs CPU {out['f32_loss_err']:.3e} / "
          f"{out['f32_param_err']:.3e}")
    if not (loss_err <= MP_LOSS_RTOL and grad_err <= MP_GRAD_RL2):
        raise SystemExit("31(a): the pipeline disagrees with the sequential "
                         "blocks")
    return out


def model_parallel_phase(fa, nccl_only=False):
    """Phase 31. Returns its readings; raises SystemExit on a failed
    check. With four cards, 31(a) runs over NCCL too, one rank a card
    (`nccl_only`: that alone)."""
    import numpy as np

    from deeplearning4j_tpu_torch import graft_entry
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    from deeplearning4j_tpu_torch.serving import InferenceServer
    from deeplearning4j_tpu_torch.util.sharded_checkpoint import \
        ShardedCheckpointManager
    t_phase = time.perf_counter()
    out = {"card": card_line(), "sub_phase_s": {}}
    print(f"phase 31: model parallelism, {MP_WORLD} gloo ranks on cuda:0 "
          f"({out['card']})")
    t = time.perf_counter()
    seq_loss, seq_grads = _mp_sequential_grads()
    torch.cuda.empty_cache()
    out["sub_phase_s"]["sequential"] = time.perf_counter() - t
    if torch.cuda.device_count() >= MP_WORLD:
        t = time.perf_counter()
        work, ranks = _mp_run_ranks("nccl")
        out["sub_phase_s"]["nccl_ranks"] = time.perf_counter() - t
        out["a_nccl"] = _mp_check_gpipe(ranks, seq_loss, seq_grads, "nccl")
        shutil.rmtree(work, ignore_errors=True)
    else:
        out["a_nccl"] = ("not run: one card; the NCCL route of phase 31 is "
                         "unverified")
        print(f"  31(a) over NCCL: {out['a_nccl']}")
    if nccl_only:
        return out
    t = time.perf_counter()
    work, ranks = _mp_run_ranks()
    out["sub_phase_s"]["ranks"] = time.perf_counter() - t
    for r, res in enumerate(ranks):
        out["sub_phase_s"][f"rank{r}"] = res["sub_phase_s"]

    out["a"] = _mp_check_gpipe(ranks, seq_loss, seq_grads, "gloo")

    # (b)
    b_out = {}
    for key in ("f32", "bf16"):
        errs = [res["b"][key]["grad_err"] for res in ranks]
        lerr = max(abs(res["b"][key]["loss"] - res["b"][key]["seq_loss"])
                   / abs(res["b"][key]["seq_loss"]) for res in ranks)
        b_out[key] = {"grad_err": max(errs), "loss_rel_err": lerr}
    b_out["losses"] = ranks[0]["b"]["losses"]
    b_out["local_wqkv"] = ranks[0]["b"]["f32"]["local_wqkv"]
    out["b"] = b_out
    print(f"  31(b) three axes (data 1, model 2, pipe 2), local wqkv "
          f"{b_out['local_wqkv']}, T=1024: f32 loss {b_out['f32']} "
          f"(1e-5), bf16 {b_out['bf16']} (loss {MP_LOSS_RTOL}, grads "
          f"{MP_TP_GRAD_RL2}); 10 bf16 steps {b_out['losses'][0]:.4f} -> "
          f"{b_out['losses'][-1]:.4f}")
    if not (b_out["f32"]["grad_err"] <= 1e-5
            and b_out["f32"]["loss_rel_err"] <= 1e-5
            and b_out["bf16"]["grad_err"] <= MP_TP_GRAD_RL2
            and b_out["bf16"]["loss_rel_err"] <= MP_LOSS_RTOL
            and b_out["losses"][-1] < b_out["losses"][0]):
        raise SystemExit("31(b): the three-axis program disagrees")

    # (c)
    c_out = {"cases": {}}
    for name in ranks[0]["c"]["cases"]:
        errs = {}
        for res in ranks:
            for k_, v_ in res["c"]["cases"][name]["errs"].items():
                errs[k_] = max(errs.get(k_, 0.0), v_)
        ids = all(res["c"]["cases"][name]["ids_equal"] for res in ranks)
        c_out["cases"][name] = {
            "max_err": max(errs.values()), "ids_equal": ids,
            "sharded_ms": max(res["c"]["cases"][name]["sharded_ms"]
                              for res in ranks)}
        if not (ids and max(errs.values()) <= 1e-5):
            raise SystemExit(f"31(c) {name}: {errs}, ids equal {ids}")
    c_out["drops"] = ranks[0]["c"]["drops"]
    c_out["block_err"] = max(res["c"]["block_err"] for res in ranks)
    out["c"] = c_out
    print(f"  31(c) MoE {MP_MOE} over {MP_WORLD} ranks, f32: {json.dumps(c_out['cases'])}; capacity moves y by "
          f"{c_out['drops']}; block step {c_out['block_err']:.3e}")
    if not (min(c_out["drops"].values()) > 1e-3
            and c_out["block_err"] <= 1e-5):
        raise SystemExit("31(c): no drop, or the MoE block step disagrees")

    # (d)
    d0 = ranks[0]["d"]
    d_out = {"param_err": max(res["d"]["param_err"] for res in ranks),
             "split": d0["split"],
             "lower_step_footprint": d0["lowered"],
             "restore_4_ranks_equal": all(res["d"]["restore_equal"]
                                          for res in ranks),
             "sharded_dir": d0["sharded_dir"],
             "step_ms": {key: max(res["d"]["step_ms"][key] for res in ranks)
                         for key in d0["step_ms"]},
             "flops_per_rank": [res["d"]["flops"] for res in ranks],
             "peak_mib_per_rank": [res["d"]["peak_mib"] for res in ranks]}
    halves = [f["tp_zero"] / f["replicated_same_rows"]
              for f in d_out["flops_per_rank"]]
    d_out["flops_split_over_replicated"] = halves
    with _cudnn_deterministic():
        one = lenet(device="cuda", updater="adam", learning_rate=1e-3,
                    seed=7)
        ShardedCheckpointManager(d0["ckpt"]).restore(one, 3)
        d_out["restore_1_rank_equal"] = bool(np.array_equal(one.params(),
                                                            d0["params"]))
        xs = _lenet_data(MP_SEED + 9, 8, 1)[0].features
        with InferenceServer(lenet(device="cuda"), max_batch=8,
                             max_wait_ms=50.0) as srv:
            srv.swap_from_checkpoint(d0["ckpt"], lambda: lenet(
                device="cuda", updater="adam", learning_rate=1e-3))
            served = np.stack([f.result(60) for f in
                               [srv.submit(r) for r in xs]])
        want = np.asarray(one.output(xs))
        d_out["swap_err"] = float(np.abs(served - want).max())
    out["d"] = d_out
    print(f"  31(d) LeNet Adam, batch 128, TP + ZeRO on (data 2, model 2) "
          f"vs replicated on 4: {d_out['param_err']:.3e} (1e-5); "
          f"split leaves {d_out['split']}; lower_step {json.dumps(d_out['lower_step_footprint'])}; "
          f"saved shard by shard {d_out['sharded_dir']}, restored "
          f"bit-equal into 4 split ranks "
          f"{d_out['restore_4_ranks_equal']}, into 1 "
          f"{d_out['restore_1_rank_equal']}; swap_from_checkpoint served "
          f"vs output {d_out['swap_err']:.3e} (1e-5); a step (fit of 3, "
          f"slowest rank): TP + ZeRO on (data 2, model 2) "
          f"{d_out['step_ms']['tp_zero']:.2f} ms, data parallel on (data 4) "
          f"{d_out['step_ms']['data_parallel']:.2f} ms ({card_line()})")
    f0 = d_out["flops_per_rank"][0]
    print(f"  31(d) FLOPs a rank in one step (FlopCounterMode): TP + ZeRO "
          f"{f0['tp_zero']:,}, data parallel on (data 4) "
          f"{f0['data_parallel']:,}, replicated on the same 64 rows "
          f"{f0['replicated_same_rows']:,}; split / replicated per rank "
          f"{', '.join(f'{h:.6f}' for h in halves)} (1/2 within 1%); peak "
          f"memory per rank, MiB: TP + ZeRO "
          f"{[round(m['tp_zero'], 1) for m in d_out['peak_mib_per_rank']]}"
          f", data parallel "
          f"{[round(m['data_parallel'], 1) for m in d_out['peak_mib_per_rank']]}"
          f" ({card_line()})")
    if not (d_out["param_err"] <= 1e-5 and d_out["split"]["other"] == 0
            and d_out["split"]["params_half"] > 0
            and d_out["split"]["state_half"] > 0
            and d_out["restore_4_ranks_equal"] and d_out["sharded_dir"]
            and d_out["restore_1_rank_equal"]
            and d_out["swap_err"] <= 1e-5
            and all(abs(h / 0.5 - 1.0) <= 0.01 for h in halves)):
        raise SystemExit("31(d): the wrapper's TP / ZeRO run disagrees")
    shutil.rmtree(work, ignore_errors=True)
    e_out = {"err": max(res["e"]["err"] for res in ranks),
             "local_d": ranks[0]["e"]["local_d"],
             "sharded_ms_per_flush": max(res["e"]["sharded_ms_per_flush"]
                                         for res in ranks),
             "whole_ms_per_flush": max(res["e"]["whole_ms_per_flush"]
                                       for res in ranks)}
    out["e"] = e_out
    print(f"  31(e) config 4's skip-gram, tables column-sharded over "
          f"{MP_WORLD} ranks ({e_out['local_d']} of {EMB_D} columns each) "
          f"vs whole: {e_out['err']:.3e} (1e-5); "
          f"{e_out['sharded_ms_per_flush']:.1f} ms a flush of 4,096 pairs "
          f"sharded (eager, host all-reduces), "
          f"{e_out['whole_ms_per_flush']:.1f} ms whole (CUDA graph)")
    if not e_out["err"] <= 1e-5:
        raise SystemExit("31(e): the sharded Word2Vec disagrees")
    flash = [res["flash_after_bcde"] for res in ranks]
    if any(any(f.values()) for f in flash):
        raise SystemExit(f"31(b)-(e) launched flash kernels: {flash}")

    # (f)
    t = time.perf_counter()
    costs = graft_entry.dryrun_multichip(MP_WORLD, device="cuda")
    out["sub_phase_s"]["f"] = time.perf_counter() - t
    launched = graft_entry.LAST_RUN["flash_launches"]
    want = {"fwd": 0, "fwd_lse": 0, "partial": MP_WORLD, "bwd_dq": 0,
            "bwd_dkv": 0}
    if launched != want:
        raise SystemExit(f"31(f) rank 0 launched {launched}: want {want} "
                         f"(K3 once a ring hop)")
    out["f"] = {"collectives": costs,
                "timings_s": graft_entry.LAST_RUN["timings_s"],
                "k3_launches_rank0": launched["partial"]}
    print(f"  31(f) dryrun_multichip({MP_WORLD}) on cuda:0 ranks: budget "
          f"gate passed; K3 launches on rank 0: {launched['partial']} (one "
          f"a ring hop, counted apart)")
    out["stage_shape"] = _mp_stage_timings(fa)
    a = out["a"]
    out["pipeline_launches"] = {
        "fwd": a["launches_forward_per_rank"]["fwd"],
        **{k: a["launches_fit_per_rank"][k] for k in ("fwd_lse", "bwd_dq",
                                                      "bwd_dkv")}}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  stage shape: {json.dumps(out['stage_shape'])}")
    print(f"  phase 31 {out['phase_s']:.1f} s ({out['sub_phase_s']})")
    return out


# -- phase 32: the training UI and the visualisation tools -------------------

UI_DEVICE = "cuda"
UI_LENET_B, UI_LENET_STEPS = 64, 20
UI_ACT_TOL = 1e-5           # activation summaries vs feed_forward, and the
                            # wrapper's global summaries vs one process
UI_R50_B, UI_R50_HW = 128, 224
UI_R50_STEPS = {None: 8, 10: 10, 1: 3}      # report frequency: steps timed
# the armed step at real width needs a MultiLayerNetwork (a graph, as
# ResNet-50, has no activation summaries, here as in the reference):
# VGG-16 bf16 at phase 29(g)'s batch; a small rate keeps its losses finite
UI_VGG_B, UI_VGG_STEPS, UI_VGG_LR = 64, 5, 1e-4
UI_RANKS = 4
UI_GROUP_TIMEOUT_S, UI_JOIN_TIMEOUT_S = 60, 240
UI_KM = dict(n=10000, d=100, k=100, steps=100)   # phase 24's EMB_V, EMB_D
UI_KM_TOL = 1e-5
# the dense loop: card vs CPU pinned over `pinned` iterations, at twice
# the CPU's own f32 vs f64 distance; over `chaos` iterations that distance
# has grown to the embedding's scale (rounding alone), so it is only read
UI_TSNE_DENSE = dict(n=4096, d=100, iters=500, pinned=5, chaos=50,
                     perplexity=30.0)
UI_TSNE_FIT_N = 1000        # Tsne.fit (dense) through the entry point
UI_TSNE_BH = dict(n=10000, d=50, iters=500, perplexity=30.0)
UI_SYM_TOL = 1e-5
UI_CSV = dict(files=256, rows=200, cols=16, prefetch=4)
UI_MAIN_TIMEOUT_S = 180
UI_PAGES = ["/", "/train/model", "/train/histogram", "/train/flow",
            "/train/activations", "/train/system", "/tsne"]


def _ui_sync():
    if UI_DEVICE == "cuda":
        torch.cuda.synchronize()


def ui_lenet_iterator():
    """The iterator factory `python -m deeplearning4j_tpu_torch.parallel.
    main --iterator-factory chip_smoke:ui_lenet_iterator` reads in 32(g):
    five batches of 64 random 28x28x1 images."""
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    return ListDataSetIterator(_par_batches(5, 64, seed=327))


def _ui_grid_shape(a, cfg):
    """(height, channels) of the grid a [B, H, W, C] output gives."""
    h, w, ch = a.shape[1:]
    step = max(1, max(h, w) // cfg.max_activation_size)
    return -(-h // step), min(ch, cfg.max_activation_channels)


def ui_lenet():
    """32(a): LeNet f32 (phase 15's), batch 64, 20 fit steps with a full
    StatsListener (score, timing, memory, learning rates, histograms,
    updates, activations armed in the step) against the same fit without
    one; the summaries against feed_forward; the legacy listeners."""
    import numpy as np

    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    from deeplearning4j_tpu_torch.ui import (ConvolutionalIterationListener,
                                             FlowIterationListener,
                                             HistogramIterationListener,
                                             InMemoryStatsStorage,
                                             StatsListener,
                                             StatsUpdateConfiguration)
    rng = np.random.default_rng(32)
    x = rng.random((UI_LENET_B, 784), dtype=np.float32)
    y = _one_hot(rng, UI_LENET_B, 10)
    cfg = StatsUpdateConfiguration(collect_histograms=True,
                                   collect_activations=True)
    store = InMemoryStatsStorage()

    def timed_fit(net):
        _ui_sync()
        t0 = time.perf_counter()
        net.fit(x, y)
        _ui_sync()
        return (time.perf_counter() - t0) * 1e3

    with _cudnn_deterministic():
        plain = lenet(device=UI_DEVICE, data_type="float32")
        plain_ms = [timed_fit(plain) for _ in range(UI_LENET_STEPS)]
        heard = lenet(device=UI_DEVICE, data_type="float32")
        listener = StatsListener(store, cfg, session_id="lenet")
        heard.set_listeners(listener)
        report_ms = []
        done = listener.iteration_done

        def timed_report(model, iteration):
            t0 = time.perf_counter()
            done(model, iteration)
            report_ms.append((time.perf_counter() - t0) * 1e3)

        listener.iteration_done = timed_report
        pre, heard_ms = [], []
        for _ in range(UI_LENET_STEPS):
            pre.append(heard.params())
            heard_ms.append(timed_fit(heard))
        if not np.array_equal(plain.params(), heard.params()):
            raise SystemExit("32(a): the fit with a StatsListener is not "
                             "bit-equal to the fit without one")
        ups = store.get_all_updates("lenet")
        if len(ups) != UI_LENET_STEPS:
            raise SystemExit(f"32(a): {len(ups)} reports")
        for key in ("score", "iterationTimeMs", "memory", "learningRates",
                    "parameters", "updates"):
            if key not in ups[-1]:
                raise SystemExit(f"32(a): the last report lacks {key}")
        if ups[-1]["memory"]["deviceBytesInUse"] <= 0 and \
                UI_DEVICE == "cuda":
            raise SystemExit("32(a): no device memory reported")
        if "histogram" not in ups[-1]["parameters"]["0_W"]:
            raise SystemExit("32(a): no histogram")
        probe = lenet(device=UI_DEVICE, data_type="float32")
        act_err, grids = 0.0, 0
        with_stats = [u for u in ups if "activationStats" in u]
        if [u["iteration"] for u in with_stats] != list(
                range(1, UI_LENET_STEPS)):
            raise SystemExit(f"32(a): activation stats at iterations "
                             f"{[u['iteration'] for u in with_stats]}")
        for u in with_stats:
            probe.set_params(pre[u["iteration"]])
            acts = probe.feed_forward(x)
            for key, s in u["activationStats"].items():
                a = np.asarray(acts[int(key) + 1], np.float64)
                act_err = max(act_err, abs(s["mean"] - a.mean()),
                              abs(s["meanMagnitude"] - np.abs(a).mean()))
                if a.ndim == 4:
                    g = u["activations"][key]
                    if (g["height"], len(g["channels"])) != \
                            _ui_grid_shape(a, cfg):
                        raise SystemExit(
                            f"32(a): layer {key} grid {g['height']} x "
                            f"{len(g['channels'])}, want "
                            f"{_ui_grid_shape(a, cfg)}")
                    grids += 1
    _check("32(a) activation summaries vs feed_forward, max abs err",
           act_err, UI_ACT_TOL)
    legacy = {}
    for name, make, key in (
            ("histogram", lambda: HistogramIterationListener(
                session_id="h"), "parameters"),
            ("convolutional", lambda: ConvolutionalIterationListener(
                x[:1], session_id="c"), "activations"),
            ("flow", lambda: FlowIterationListener(session_id="f"),
             "score")):
        net = lenet(device=UI_DEVICE, data_type="float32")
        listener = make()
        net.set_listeners(listener)
        for _ in range(2):
            net.fit(x, y)
        lu = listener.router.get_all_updates(listener.session_id)
        if len(lu) != 2 or key not in lu[-1]:
            raise SystemExit(f"32(a): the {name} listener reported "
                             f"{[sorted(u) for u in lu]}")
        legacy[name] = sorted(lu[-1])
    # medians past the first step (cuDNN's first call of each shape)
    out = {"steps": UI_LENET_STEPS, "bit_equal_without_listener": True,
           "activation_max_abs_err": act_err, "grids_checked": grids,
           "fit_ms_without_listener": statistics.median(plain_ms[1:]),
           "fit_ms_with_listener": statistics.median(heard_ms[1:]),
           "report_ms": statistics.median(report_ms[1:]),
           "legacy_report_keys": legacy}
    print(f"  32(a) LeNet f32 x{UI_LENET_STEPS}: with a full StatsListener "
          f"bit-equal to without; {len(with_stats)} reports of the step's "
          f"activations vs feed_forward {act_err:.2e}, {grids} grids; a fit "
          f"{out['fit_ms_without_listener']:.2f} ms without, "
          f"{out['fit_ms_with_listener']:.2f} ms with the listener, of it "
          f"the report {out['report_ms']:.2f} ms (medians)")
    return out


def _ui_get(url, data=None):
    import urllib.request
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=30) as r:
        body = r.read()
        status = r.status
    return status, body, (time.perf_counter() - t0) * 1e3


def ui_resnet(storage):
    """32(b): ResNet-50 bf16 at phase 17's width: the step with no
    listener, with a StatsListener at report frequency 10 and 1 (reports
    into the SqliteStatsStorage `storage`), and the host bytes a report
    reads."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.zoo.resnet import resnet50
    from deeplearning4j_tpu_torch.ui import (StatsListener,
                                             StatsUpdateConfiguration)
    torch.cuda.empty_cache()
    net = resnet50(data_type="bfloat16", device=UI_DEVICE)
    gen = torch.Generator(device=UI_DEVICE).manual_seed(32)
    x = torch.rand((UI_R50_B, UI_R50_HW, UI_R50_HW, 3), generator=gen,
                   device=UI_DEVICE)
    y = torch.nn.functional.one_hot(torch.randint(
        0, 1000, (UI_R50_B,), generator=gen, device=UI_DEVICE), 1000).float()
    ds = DataSet(x, y)
    for _ in range(3):          # cuDNN's search, off the clock
        net.fit(ds)
    _ui_sync()
    out = {"batch": UI_R50_B, "steps": {}, "step_ms": {}, "reports": {},
           "report_ms": {}}
    for freq, steps in UI_R50_STEPS.items():
        name = "none" if freq is None else f"every_{freq}"
        listener = None
        if freq is not None:
            listener = StatsListener(storage, StatsUpdateConfiguration(
                report_frequency=freq), session_id=f"resnet50_{name}")
            net.set_listeners(listener)
            heard = listener.iteration_done
            spent = [0.0]

            def timed(model, iteration, heard=heard, spent=spent,
                      freq=freq):
                if iteration % freq:
                    return heard(model, iteration)
                _ui_sync()
                t = time.perf_counter()
                heard(model, iteration)
                spent[0] += time.perf_counter() - t
            listener.iteration_done = timed
        else:
            net.set_listeners()
        before = len(storage.get_all_updates(f"resnet50_{name}"))
        t0 = time.perf_counter()
        for _ in range(steps):
            net.fit(ds)
        _ui_sync()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        out["steps"][name] = steps
        out["step_ms"][name] = ms
        if listener is not None:
            n = len(storage.get_all_updates(f"resnet50_{name}")) - before
            out["reports"][name] = n
            if n != steps // freq:
                raise SystemExit(f"32(b): {n} reports at frequency {freq}")
            # the listener's time over its reports (the other calls return
            # at once), the step's queue drained first
            out["report_ms"][name] = spent[0] * 1e3 / n
            out["host_bytes_per_report"] = 4 + sum(
                a.nbytes for a in listener._prev_params.values())
    net.set_listeners()
    out["num_params"] = net.num_params()
    print(f"  32(b) ResNet-50 bf16 batch {UI_R50_B}: step "
          f"{out['step_ms']['none']:.1f} ms without a listener, "
          f"{out['step_ms']['every_10']:.1f} ms reporting every 10, "
          f"{out['step_ms']['every_1']:.1f} ms every step; a report "
          f"{out['report_ms']['every_1']:.0f} ms, "
          f"{out['host_bytes_per_report'] / 2 ** 20:.1f} MiB read to the "
          f"host")
    del net, ds, x, y
    torch.cuda.empty_cache()
    return out


def ui_armed_vgg():
    """32(b): the step with its activation summaries armed at real width:
    VGG-16 bf16, batch 64, 224x224x3, disarmed then armed (the same
    batches), each step timed by CUDA events, with the peak memory; the
    armed step's summaries finite."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.zoo.classic_cnns import vgg16
    torch.cuda.empty_cache()
    net = vgg16(data_type="bfloat16", learning_rate=UI_VGG_LR,
                device=UI_DEVICE)
    gen = torch.Generator(device=UI_DEVICE).manual_seed(329)
    x = torch.rand((UI_VGG_B, 224, 224, 3), generator=gen, device=UI_DEVICE)
    y = torch.nn.functional.one_hot(torch.randint(
        0, 1000, (UI_VGG_B,), generator=gen, device=UI_DEVICE), 1000).float()
    ds = DataSet(x, y)
    out = {"batch": UI_VGG_B, "steps": UI_VGG_STEPS, "step_ms": {},
           "peak_gib": {}}
    for armed in (False, True):
        name = "armed" if armed else "disarmed"
        net.collect_activation_stats(armed)
        net.fit(ds)             # cuDNN's search / the first armed step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(UI_VGG_STEPS + 1)]
        ev[0].record()
        for i in range(UI_VGG_STEPS):
            net.fit(ds)
            ev[i + 1].record()
        torch.cuda.synchronize()
        out["step_ms"][name] = statistics.median(
            a.elapsed_time(b) for a, b in zip(ev, ev[1:]))
        out["peak_gib"][name] = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = net._last_activation_stats
    net.collect_activation_stats(False)
    means = np.array([float(s["mean"]) for s in stats])
    if len(stats) != len(net.layers) - 1 or not np.isfinite(means).all():
        raise SystemExit(f"32(b): VGG-16's armed step left {len(stats)} "
                         f"summaries, means {means}")
    if not math.isfinite(float(net.score())):
        raise SystemExit("32(b): VGG-16's loss is not finite")
    out["armed_over_disarmed"] = (out["step_ms"]["armed"]
                                  / out["step_ms"]["disarmed"])
    print(f"  32(b) VGG-16 bf16 batch {UI_VGG_B}: step "
          f"{out['step_ms']['disarmed']:.1f} ms disarmed, "
          f"{out['step_ms']['armed']:.1f} ms with the activation summaries "
          f"armed ({out['armed_over_disarmed']:.3f}x); peak memory "
          f"{out['peak_gib']['disarmed']:.2f} vs "
          f"{out['peak_gib']['armed']:.2f} GiB (medians of "
          f"{UI_VGG_STEPS} steps, CUDA events)")
    del net, ds, x, y
    torch.cuda.empty_cache()
    return out


def ui_server(storage, base):
    """32(b): every page and /api route of the UIServer at `base` over
    `storage` (200, with the session's updates), each timed; a
    RemoteUIStatsStorageRouter posting into it; /metrics."""
    from deeplearning4j_tpu_torch.ui import RemoteUIStatsStorageRouter
    sid = "resnet50_every_1"
    want = storage.get_all_updates(sid)
    page_ms = {}
    for path in UI_PAGES + ["/api/sessions", f"/api/static/{sid}",
                            f"/api/updates/{sid}", "/metrics"]:
        status, body, ms = _ui_get(base + path)
        if status != 200:
            raise SystemExit(f"32(b): {path} answered {status}")
        page_ms[path] = ms
        if path.startswith("/api/updates/") and json.loads(body) != want:
            raise SystemExit("32(b): /api/updates differs from the storage")
        if path == "/api/sessions" and sid not in json.loads(body):
            raise SystemExit(f"32(b): /api/sessions lacks {sid}")
    coords = {"coords": [[0.0, 1.0], [2.0, 3.0]], "labels": ["a", "b"]}
    status, body, page_ms["POST /api/tsne"] = _ui_get(
        f"{base}/api/tsne/{sid}", json.dumps(coords).encode())
    status, body, page_ms["/api/tsne"] = _ui_get(f"{base}/api/tsne/{sid}")
    if json.loads(body)["coords"] != coords["coords"]:
        raise SystemExit("32(b): the t-SNE upload did not come back")
    router = RemoteUIStatsStorageRouter(base)
    t0 = time.perf_counter()
    router.put_static_info({"sessionId": "remote_probe",
                            "model": {"class": "probe", "numParams": 1}})
    router.put_update({"sessionId": "remote_probe", "iteration": 0,
                       "score": 1.5})
    remote_ms = (time.perf_counter() - t0) * 1e3 / 2
    if storage.get_all_updates("remote_probe") != [
            {"sessionId": "remote_probe", "iteration": 0, "score": 1.5}]:
        raise SystemExit("32(b): the remote router's update did not land")
    print(f"  32(b) UIServer: {len(page_ms)} routes 200; ms "
          f"{json.dumps({k: round(v, 2) for k, v in page_ms.items()})}; "
          f"a remote POST {remote_ms:.2f} ms")
    return {"route_ms": page_ms, "remote_post_ms": remote_ms,
            "updates_served": len(want)}


def ui_rank(rank, world, store, out_dir):
    """One rank of 32(c), started by spawn: LeNet f32 through the wrapper
    in all-reduce mode on cuda:0 in a gloo group, activation stats armed
    on every rank (the summaries are collective), a StatsListener on rank
    0; then rank 0 runs the same batches in one process, armed."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.ui import (InMemoryStatsStorage,
                                             StatsListener,
                                             StatsUpdateConfiguration)
    if UI_DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=UI_GROUP_TIMEOUT_S))
    torch.backends.cudnn.deterministic = True
    batches = _par_batches(3, 64, seed=323)
    cfg = StatsUpdateConfiguration(collect_activations=True)

    def reports(net, fit):
        storage = InMemoryStatsStorage()
        net.collect_activation_stats(True, cfg.max_activation_channels,
                                     cfg.max_activation_size)
        if rank == 0:
            net.set_listeners(StatsListener(storage, cfg, session_id="s"))
        fit(net)
        return [{"iteration": u["iteration"],
                 "activationStats": u.get("activationStats"),
                 "activations": u.get("activations")}
                for u in storage.get_all_updates("s")]

    res = {"wrapper": reports(
        lenet(device=UI_DEVICE, data_type="float32"),
        lambda net: ParallelWrapper.Builder(net).averaging_frequency(1)
        .build().fit(ListDataSetIterator(batches)))}
    dist.barrier()
    if rank == 0:
        def one(net):
            for ds in batches:
                net.fit(ds)
        res["one_process"] = reports(
            lenet(device=UI_DEVICE, data_type="float32"), one)
        torch.save(res, Path(out_dir) / "rank0.pt")
    dist.barrier()
    dist.destroy_process_group()


def ui_wrapper():
    """32(c): the wrapper's global-batch summaries on UI_RANKS gloo ranks
    against one process's summaries of the whole batch."""
    import tempfile
    work = Path(tempfile.mkdtemp(prefix="phase32c_", dir=str(
        Path(__file__).resolve().parent / "build")))
    store = str(work / "store")
    t0 = time.perf_counter()
    _par_spawn(ui_rank, lambda i: (i, UI_RANKS, store, str(work)),
               UI_RANKS, UI_JOIN_TIMEOUT_S, "32(c) ranks")
    spawn_s = time.perf_counter() - t0
    res = torch.load(work / "rank0.pt", weights_only=False)
    shutil.rmtree(work, ignore_errors=True)
    wrap, one = res["wrapper"], res["one_process"]
    if [u["iteration"] for u in wrap] != [u["iteration"] for u in one] \
            or not any(u["activationStats"] for u in wrap):
        raise SystemExit("32(c): the reports differ in their iterations")
    err, grids = 0.0, 0
    for a, b in zip(wrap, one):
        if bool(a["activationStats"]) != bool(b["activationStats"]):
            raise SystemExit(f"32(c): iteration {a['iteration']} has stats "
                             f"on one side only")
        for key, s in (a["activationStats"] or {}).items():
            t = b["activationStats"][key]
            err = max(err, *(abs(s[k] - t[k]) for k in s))
        for key, g in (a["activations"] or {}).items():
            h = b["activations"][key]
            if (g["height"], len(g["channels"])) != (h["height"],
                                                     len(h["channels"])):
                raise SystemExit(f"32(c): layer {key}'s grid shape differs")
            grids += 1
    _check(f"32(c) {UI_RANKS} ranks' global summaries vs one process, max "
           f"abs err", err, UI_ACT_TOL)
    return {"ranks": UI_RANKS, "reports": len(wrap),
            "max_abs_err": err, "grids": grids, "spawn_s": spawn_s}


def ui_kmeans():
    """32(d): k-means over config 4's table shape on the card against the
    port on the CPU from the same seed."""
    import numpy as np

    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.clustering import kmeans as K
    n, d, k = UI_KM["n"], UI_KM["d"], UI_KM["k"]
    rng = np.random.default_rng(324)
    centers = 4.0 * rng.standard_normal((k, d))
    x = (centers[rng.integers(0, k, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    card = KMeansClustering(k, max_iterations=UI_KM["steps"], seed=324,
                            device=UI_DEVICE)
    init = {}
    pp = card._init_pp

    def cached(x, r):
        init["c"] = pp(x, r)
        return init["c"]

    card._init_pp = cached
    steps_ms = {UI_DEVICE: [], "cpu": []}
    step = K._lloyd_step

    def fit(km, device):
        """km.fit(x), each Lloyd step timed (the queue drained around)."""
        def timed(*a):
            _ui_sync()
            t0 = time.perf_counter()
            r = step(*a)
            _ui_sync()
            steps_ms[device].append((time.perf_counter() - t0) * 1e3)
            return r
        K._lloyd_step = timed
        try:
            km.fit(x)
        finally:
            K._lloyd_step = step

    t0 = time.perf_counter()
    fit(card, UI_DEVICE)
    fit_s = time.perf_counter() - t0
    cpu = KMeansClustering(k, max_iterations=UI_KM["steps"], seed=324,
                           device="cpu")
    cpu._init_pp = lambda x, r: init["c"]
    fit(cpu, "cpu")
    n_steps = len(steps_ms[UI_DEVICE])
    if n_steps != len(steps_ms["cpu"]):
        raise SystemExit(f"32(d): {n_steps} steps on the card, "
                         f"{len(steps_ms['cpu'])} on the CPU")
    center_err = _max_err(card.centers, cpu.centers)
    xc = torch.from_numpy(x).double()
    dist2 = torch.cdist(xc, torch.from_numpy(cpu.centers).double()) ** 2
    two = dist2.topk(2, largest=False).values.numpy()
    near_tie = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 1]
    differ = card.labels != cpu.labels
    if np.any(differ & ~near_tie):
        raise SystemExit(f"32(d): {int((differ & ~near_tie).sum())} labels "
                         f"differ away from a near-tie")
    cost_rel = abs(card.cost - cpu.cost) / abs(cpu.cost)
    _check("32(d) k-means centers card vs CPU, max abs err", center_err,
           UI_KM_TOL)
    _check("32(d) k-means cost card vs CPU, relative", cost_rel, UI_KM_TOL)
    card_ms = steps_ms[UI_DEVICE]
    out = {"n": n, "d": d, "k": k, "steps": n_steps,
           "fit_s": fit_s, "step_ms": card_ms,
           "mean_step_ms": sum(card_ms[1:]) / max(1, n_steps - 1),
           "center_max_abs_err": center_err, "cost_rel_err": cost_rel,
           "labels_differing": int(differ.sum()),
           "near_ties": int(near_tie.sum())}
    print(f"  32(d) k-means {n}x{d}, K={k}: {n_steps} Lloyd steps "
          f"of {out['mean_step_ms']:.3f} ms on the card (fit {fit_s:.1f} s "
          f"with the kmeans++ seeding on the host); labels differing "
          f"{out['labels_differing']}, near-ties {out['near_ties']}")
    return out


def _ui_blobs(n, d, c, scale, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(c), n // c)
    centers = scale * rng.standard_normal((c, d))
    return (centers[labels] + rng.standard_normal((n, d))), labels


def _ui_spread(emb, labels):
    """The reference's pin: mean inter- over mean intra-cluster distance
    on its sample of pairs (i every 7th, j every 11th after it)."""
    import numpy as np
    n = emb.shape[0]
    ii, jj = [], []
    for i in range(0, n, 7):
        j = np.arange(i + 1, n, 11)
        ii.append(np.full(j.shape, i))
        jj.append(j)
    ii, jj = np.concatenate(ii), np.concatenate(jj)
    dd = np.linalg.norm(emb[ii] - emb[jj], axis=1)
    same = labels[ii] == labels[jj]
    return float(dd[~same].mean() / dd[same].mean())


def ui_tsne():
    """32(e): the dense loop card vs CPU on the same P and y0 (the first
    iterations pinned against the CPU's f32 vs f64 distance, a longer run
    read, the whole loop timed), `Tsne.fit` (dense) through the
    entry point, Barnes-Hut at 10,000 points: `_sparse_sym_p` card vs CPU,
    the native forces' share, the fit; the separation pins."""
    import numpy as np

    from deeplearning4j_tpu_torch.common import native_ops
    from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne
    from deeplearning4j_tpu_torch.plot import tsne as T
    cfg = UI_TSNE_DENSE
    n, pinned = cfg["n"], cfg["pinned"]
    x, labels = _ui_blobs(n, cfg["d"], 8, 4.0, 325)
    # P: the kNN P, symmetrised, densified (the dense fit's _cond_probs
    # holds an [N, N, D] f64 array, 13 GB at this N)
    row_ptr, cols, vals = T._sparse_sym_p(x, cfg["perplexity"],
                                          device=UI_DEVICE)
    P = np.zeros((n, n), np.float32)
    P[np.repeat(np.arange(n), np.diff(row_ptr)), cols] = vals
    gen = torch.Generator().manual_seed(325)
    y0 = 1e-2 * torch.randn((n, 2), generator=gen)
    Pc = torch.from_numpy(P)
    Pd = Pc.to(UI_DEVICE)

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())

    # the CPU's f32 loop against its f64 loop: how far rounding alone
    # carries the loop in this many iterations
    t0 = time.perf_counter()
    cpu = T._tsne_loop(Pc, y0, pinned)
    cpu_s = time.perf_counter() - t0
    cpu64 = T._tsne_loop(Pc.double(), y0.double(), pinned)
    card = T._tsne_loop(Pd, y0.to(UI_DEVICE), pinned).cpu()
    spread, err = rel(cpu, cpu64), rel(card, cpu)
    _check(f"32(e) dense t-SNE loop card vs CPU f32 over {pinned} "
           f"iterations, relative (limit 2x the CPU's f32 vs f64 "
           f"{spread:.3e})", err, 2 * spread)
    # how far rounding alone has carried the loop after `chaos`
    # iterations: the card's f32 loop against its f64 loop
    chaos = {"iterations": cfg["chaos"],
             "card_f32_vs_f64_rel": rel(
                 T._tsne_loop(Pd, y0.to(UI_DEVICE), cfg["chaos"]).cpu(),
                 T._tsne_loop(Pd.double(), y0.double().to(UI_DEVICE),
                              cfg["chaos"]).cpu())}
    _ui_sync()
    t0 = time.perf_counter()
    emb = T._tsne_loop(Pd, y0.to(UI_DEVICE), cfg["iters"])
    _ui_sync()
    loop_s = time.perf_counter() - t0
    dense_spread = _ui_spread(emb.cpu().numpy(), labels)
    xs, ls = _ui_blobs(UI_TSNE_FIT_N, 10, 5, 4.0, 326)
    t0 = time.perf_counter()
    fit_emb = Tsne(perplexity=30, max_iter=300, seed=3,
                   device=UI_DEVICE).fit(xs)
    fit_s = time.perf_counter() - t0
    fit_spread = _ui_spread(fit_emb, ls)
    # Barnes-Hut
    bh = UI_TSNE_BH
    xb, lb = _ui_blobs(bh["n"], bh["d"], 10, 8.0, 327)
    xb = np.round(4.0 * xb) / 4.0     # exact f32 products on both devices
    t0 = time.perf_counter()
    card_p = T._sparse_sym_p(xb, bh["perplexity"], device=UI_DEVICE)
    sym_card_s = time.perf_counter() - t0
    cpu_p = T._sparse_sym_p(xb, bh["perplexity"], device="cpu")
    if not (np.array_equal(card_p[0], cpu_p[0])
            and np.array_equal(card_p[1], cpu_p[1])):
        raise SystemExit("32(e) _sparse_sym_p: the CSR patterns differ")
    sym_err = float(np.abs(card_p[2] - cpu_p[2]).max() / cpu_p[2].max())
    _check("32(e) _sparse_sym_p card vs CPU values, relative to the "
           "largest", sym_err, UI_SYM_TOL)
    force_s = {"attraction": 0.0, "repulsion": 0.0}
    calls = {"attraction": 0, "repulsion": 0}
    orig = {"attraction": native_ops.bh_attraction,
            "repulsion": native_ops.bh_repulsion}

    def timed(kind):
        def call(*a, **kw):
            t = time.perf_counter()
            r = orig[kind](*a, **kw)
            force_s[kind] += time.perf_counter() - t
            calls[kind] += r is not None
            return r
        return call

    native_ops.bh_attraction = timed("attraction")
    native_ops.bh_repulsion = timed("repulsion")
    try:
        t0 = time.perf_counter()
        bh_emb = BarnesHutTsne(perplexity=bh["perplexity"],
                               max_iter=bh["iters"], seed=4,
                               device=UI_DEVICE).fit(xb)
        bh_s = time.perf_counter() - t0
    finally:
        native_ops.bh_attraction = orig["attraction"]
        native_ops.bh_repulsion = orig["repulsion"]
    if calls != {"attraction": bh["iters"], "repulsion": bh["iters"]}:
        raise SystemExit(f"32(e): the native forces ran {calls}")
    bh_spread = _ui_spread(bh_emb, lb)
    for label, s in (("dense loop", dense_spread), ("Tsne.fit", fit_spread),
                     ("Barnes-Hut", bh_spread)):
        if not s > 2:
            raise SystemExit(f"32(e) {label}: inter/intra {s:.2f}, the "
                             f"clusters did not stay separated")
    out = {"dense": {"n": n, "pinned_iterations": pinned,
                     "card_vs_cpu_rel": err, "cpu_f32_vs_f64_rel": spread,
                     "card_vs_cpu_f64_rel": rel(card, cpu64),
                     "cpu_loop_s": cpu_s, "chaos": chaos,
                     "iterations": cfg["iters"],
                     "loop_s": loop_s,
                     "ms_per_iteration": loop_s * 1e3 / cfg["iters"],
                     "inter_over_intra": dense_spread},
           "fit_dense": {"n": UI_TSNE_FIT_N, "fit_s": fit_s,
                         "inter_over_intra": fit_spread},
           "barnes_hut": {"n": bh["n"], "iterations": bh["iters"],
                          "sparse_sym_p_card_s": sym_card_s,
                          "sparse_sym_p_rel_err": sym_err,
                          "nnz": int(card_p[0][-1]), "fit_s": bh_s,
                          "force_s": force_s,
                          "force_share": sum(force_s.values()) / bh_s,
                          "inter_over_intra": bh_spread}}
    print(f"  32(e) dense t-SNE N={n}: {pinned} iterations card vs CPU "
          f"{err:.2e} (CPU f32 vs f64 {spread:.2e}), {cfg['chaos']} "
          f"iterations the card's f32 vs f64 "
          f"{chaos['card_f32_vs_f64_rel']:.2e} (read, not held: chaotic); "
          f"{cfg['iters']} "
          f"iterations {loop_s:.2f} s on the card "
          f"({out['dense']['ms_per_iteration']:.2f} ms each); inter/intra "
          f"{dense_spread:.2f}; Tsne.fit N={UI_TSNE_FIT_N} {fit_s:.1f} s "
          f"({fit_spread:.2f})")
    print(f"  32(e) Barnes-Hut N={bh['n']}: _sparse_sym_p card vs CPU "
          f"pattern equal, values {sym_err:.2e}; fit {bh_s:.1f} s, native "
          f"forces {out['barnes_hut']['force_share']:.0%} of it; "
          f"inter/intra {bh_spread:.2f}")
    return out


def ui_prefetch():
    """32(f): CSVSequenceRecordReader(prefetch=4) over 256 numeric files
    equals prefetch=0, row for row; rows/s both ways."""
    import tempfile

    import numpy as np

    from deeplearning4j_tpu_torch.datasets.records import \
        CSVSequenceRecordReader
    c = UI_CSV
    work = Path(tempfile.mkdtemp(prefix="phase32f_", dir=str(
        Path(__file__).resolve().parent / "build")))
    rng = np.random.default_rng(328)
    paths = []
    for i in range(c["files"]):
        p = work / f"s{i:04d}.csv"
        np.savetxt(p, rng.random((c["rows"], c["cols"])), delimiter=",",
                   fmt="%.6f")
        paths.append(str(p))
    seqs, rate = {}, {}
    for prefetch in (0, c["prefetch"]):
        r = CSVSequenceRecordReader(files=paths, prefetch=prefetch)
        t0 = time.perf_counter()
        got = []
        while r.has_next():
            got.append(r.next_sequence())
        rate[prefetch] = c["files"] * c["rows"] / (time.perf_counter() - t0)
        if prefetch and r._loader is None:
            raise SystemExit("32(f): prefetch did not use the native loader")
        seqs[prefetch] = got
    shutil.rmtree(work, ignore_errors=True)
    plain = [[[float(np.float32(v)) for v in row] for row in s]
             for s in seqs[0]]
    if plain != seqs[c["prefetch"]]:
        raise SystemExit("32(f): prefetch differs from prefetch=0")
    print(f"  32(f) {c['files']} CSV files of {c['rows']} rows: prefetch="
          f"{c['prefetch']} equal to prefetch=0 row for row; "
          f"{rate[c['prefetch']]:.0f} rows/s against {rate[0]:.0f}")
    return {"files": c["files"], "rows_per_file": c["rows"],
            "rows_per_s_prefetch": rate[c["prefetch"]],
            "rows_per_s_plain": rate[0]}


def ui_main_start(base):
    """32(g), started: `python -m deeplearning4j_tpu_torch.parallel.main`
    on the card, a LeNet zip, one epoch, the model written and the stats
    posted to the server at `base`. Returns what ui_main_check needs."""
    import tempfile

    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    from deeplearning4j_tpu_torch.util import model_serializer as ms
    root = Path(__file__).resolve().parent
    work = Path(tempfile.mkdtemp(prefix="phase32g_", dir=str(root / "build")))
    src, dst = str(work / "lenet.zip"), str(work / "trained.zip")
    ms.write_model(lenet(device=UI_DEVICE, data_type="float32"), src)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.parallel.main",
         "--model-path", src, "--iterator-factory",
         "chip_smoke:ui_lenet_iterator", "--epochs", "1",
         "--model-output-path", dst, "--ui-url", base, "--report-score",
         "--device", UI_DEVICE],
        cwd=str(root), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    return {"proc": proc, "work": work, "src": src, "dst": dst,
            "t0": time.perf_counter()}


def ui_main_check(started, storage, sessions_before):
    """32(g), finished: the zip restores, its parameters are finite and
    changed, and the server holds the run's session."""
    import numpy as np

    from deeplearning4j_tpu_torch.util import model_serializer as ms
    proc = started["proc"]
    try:
        text, _ = proc.communicate(timeout=UI_MAIN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        text, _ = proc.communicate()
        raise SystemExit(f"32(g) timed out: {text.decode()[-2000:]}")
    wall_s = time.perf_counter() - started["t0"]
    if proc.returncode != 0:
        raise SystemExit(f"32(g) exited {proc.returncode}: "
                         f"{text.decode()[-3000:]}")
    before = ms.restore_model(started["src"], device=UI_DEVICE).params()
    after = ms.restore_model(started["dst"], device=UI_DEVICE)
    p = after.params()
    if not np.all(np.isfinite(p)) or np.array_equal(p, before):
        raise SystemExit("32(g): the written parameters are not finite or "
                         "did not change")
    new = [s for s in storage.list_session_ids() if s not in sessions_before
           and s.startswith("session_")]
    if len(new) != 1:
        raise SystemExit(f"32(g): the server holds sessions {new}")
    static = storage.get_static_info(new[0])
    ups = storage.get_all_updates(new[0])
    if static["model"]["numParams"] != after.num_params() or len(ups) != 5:
        raise SystemExit(f"32(g): session {new[0]}: {static['model']}, "
                         f"{len(ups)} updates")
    shutil.rmtree(started["work"], ignore_errors=True)
    print(f"  32(g) parallel.main on the card: {wall_s:.1f} s with its "
          f"start; the zip restores, parameters finite and changed; "
          f"session {new[0]} with {len(ups)} updates on the server "
          f"({text.decode().strip().splitlines()[-1]})")
    return {"wall_s": wall_s, "session": new[0], "updates": len(ups),
            "iterations": after.conf.iteration_count}


def ui_phase(fa):
    """Phase 32. Returns its readings. The UI and the visualisation tools
    run no kernel of the port: the counters are set to 0 first and must
    read 0 after it."""
    import tempfile

    from deeplearning4j_tpu_torch.ui import SqliteStatsStorage, UIServer
    t_phase = time.perf_counter()
    fa.reset_launches()
    out = {"card": card_line() if UI_DEVICE == "cuda" else "cpu",
           "sub_phase_s": {}}
    print(f"phase 32: the training UI and the visualisation tools "
          f"({out['card']})")
    work = Path(tempfile.mkdtemp(prefix="phase32_", dir=str(
        Path(__file__).resolve().parent / "build")))
    storage = SqliteStatsStorage(str(work / "stats.db"))
    server = UIServer(port=0).attach(storage)
    base = f"http://127.0.0.1:{server.port}"
    try:
        t = time.perf_counter()
        out["a"] = ui_lenet()
        out["sub_phase_s"]["a"] = time.perf_counter() - t
        t = time.perf_counter()
        out["b"] = ui_resnet(storage)
        out["b"]["server"] = ui_server(storage, base)
        if UI_DEVICE == "cuda":         # CUDA events and peak memory
            out["b"]["armed_vgg16"] = ui_armed_vgg()
        out["sub_phase_s"]["b"] = time.perf_counter() - t
        # (g) runs in its own process while (c) and (d) run here
        sessions = storage.list_session_ids()
        started = ui_main_start(base)
        for key, fn in (("c", ui_wrapper), ("d", ui_kmeans)):
            t = time.perf_counter()
            out[key] = fn()
            out["sub_phase_s"][key] = time.perf_counter() - t
        t = time.perf_counter()
        out["g"] = ui_main_check(started, storage, sessions)
        out["sub_phase_s"]["g_wait"] = time.perf_counter() - t
        for key, fn in (("e", ui_tsne), ("f", ui_prefetch)):
            t = time.perf_counter()
            out[key] = fn()
            out["sub_phase_s"][key] = time.perf_counter() - t
    finally:
        server.stop()
        storage.close()
        shutil.rmtree(work, ignore_errors=True)
    if UI_DEVICE == "cuda":
        torch.cuda.empty_cache()
    launched = dict(fa.launches)
    if any(launched.values()):
        raise SystemExit(f"phase 32 launched flash kernels: {launched}")
    out["flash_launches"] = launched
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 32 launched no kernel of the port: {launched}; "
          f"{out['phase_s']:.1f} s ({out['sub_phase_s']})")
    return out


# ---------------------------------------------------------------------------
# Phase 33: graph embeddings, streaming and object-store training
# ---------------------------------------------------------------------------

# BlogCatalog, the first dataset of the DeepWalk paper (Perozzi et al., KDD
# 2014, Table 1): 10,312 vertices, 333,983 edges, 39 labels; drawn here as
# a planted partition with 90% of the edges inside a community
GS_BLOG = dict(vertices=10312, edges=333983, communities=39, intra=0.9,
               seed=330)
GS_DW = dict(vector=128, window=10, walk=40, epochs=1, seed=331)  # d, w, t
GS_QUALITY = dict(probes=200, top=10, over_chance=5.0, seed=332)
GS_SMALL = dict(vertices=500, edges=4000, communities=8, intra=0.9,
                seed=333, vector=32, walk=20, window=5, epochs=2)
GS_TOL = 1e-5               # phase 24's bound, card against CPU
GS_BATCHES = 20             # (b): LeNet f32 batches of 64 a pipeline
GS_RESNET = dict(batch=32, payloads=8, seed=337)
GS_STORE_BATCHES = 16       # (c): LeNet batches in the object store
GS_MAIN_STEPS = 2           # (c): global batches of the provisioned ranks
GS_MAIN_TIMEOUT_S = 240
GS_COLLECT_TIMEOUT_S = 120


def gs_planted_partition(G, vertices, edges, communities, intra, seed):
    """A planted-partition graph of class G (either package's `Graph`):
    vertex v in community v % communities, `edges` distinct undirected
    edges, round(intra * edges) of them inside a community, drawn from a
    numpy seed and added in a random order. Returns (graph, community of
    each vertex)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    C = communities
    comm = np.arange(vertices) % C
    n_in = int(round(intra * edges))
    sizes = np.bincount(comm)
    if n_in > int((sizes * (sizes - 1) // 2).sum()):
        raise ValueError(f"{n_in} edges do not fit inside {C} communities "
                         f"of {vertices} vertices")
    keys = np.zeros(0, np.int64)
    for inside, n in ((True, n_in), (False, edges - n_in)):
        got = np.zeros(0, np.int64)
        while len(got) < n:
            m = 2 * (n - len(got)) + 64
            u = rng.integers(0, vertices, m)
            if inside:      # a partner from u's community: c, c + C, ...
                c = u % C
                v = c + C * rng.integers(0, (vertices - c + C - 1) // C)
            else:
                v = rng.integers(0, vertices, m)
            ok = (u != v) & ((comm[u] == comm[v]) == inside)
            k = (np.minimum(u, v) * vertices + np.maximum(u, v))[ok]
            _, first = np.unique(k, return_index=True)
            k = k[np.sort(first)]                  # in the order drawn
            k = k[~np.isin(k, keys) & ~np.isin(k, got)]
            got = np.concatenate([got, k[:n - len(got)]])
        keys = np.concatenate([keys, got])
    keys = keys[rng.permutation(len(keys))]
    g = G(vertices)
    for u, v in zip((keys // vertices).tolist(), (keys % vertices).tolist()):
        g.add_edge(u, v)
    return g, comm


@contextlib.contextmanager
def _gs_counted_learners():
    """Collects (valid pairs, flushes) from every skip-gram learner that
    finishes inside the block: the learner's own counters, read as it
    finishes (SequenceVectors keeps its learner local to `fit`)."""
    from deeplearning4j_tpu_torch.models.embeddings import learning
    seen = []
    finish = learning.SkipGram.finish

    def counted(self):
        finish(self)
        seen.append((self._flushed_pairs, self.flushes))

    learning.SkipGram.finish = counted
    try:
        yield seen
    finally:
        del learning.SkipGram.finish        # back to the base class's


def gs_traced_flush(dw, walks):
    """The busy share of one flush of DeepWalk's learner at full width: a
    SkipGram learner on the trained vocab and tables, 4,096 pairs of the
    native generator from the first walks; one flush captures its CUDA
    graph, the next is traced."""
    from deeplearning4j_tpu_torch.common import native_ops
    from deeplearning4j_tpu_torch.models.embeddings import learning
    vocab = dw._sv.vocab
    learner = learning.SkipGram().configure(
        vocab, dw._sv.lookup, window=GS_DW["window"], negative=0,
        use_hs=True, seed=GS_DW["seed"], device="cuda")
    ids = [[vocab.index_of(str(v)) for v in w] for w in walks[:128]]
    _, (c, o) = learner._corpus_chunk(ids, native_ops.skipgram_pairs)
    B = learner.batch_pairs
    if len(c) < 2 * B:
        raise SystemExit(f"33(a): {len(c)} pairs from 128 walks")
    learner.enqueue_pairs(c[:B], o[:B], 0.025)       # captures the graph
    torch.cuda.synchronize()
    out = _traced(lambda: learner.enqueue_pairs(c[B:2 * B], o[B:2 * B],
                                                0.025))
    if learner.flushes != 1 + out["attempts"]:      # one a traced call
        raise SystemExit(f"33(a): {learner.flushes} flushes in "
                         f"{out['attempts']} traced calls and a warm one")
    out["pairs"] = B
    out["code_length"] = learner._max_code_len
    return out


def gs_deepwalk_full():
    """33(a): DeepWalk at BlogCatalog's size on the card. Returns its
    readings."""
    import numpy as np

    from deeplearning4j_tpu_torch.common import native_ops
    from deeplearning4j_tpu_torch.graph import (DeepWalk, Graph,
                                                RandomWalkIterator)
    b, d, q = GS_BLOG, GS_DW, GS_QUALITY
    print(f"phase 33(a): DeepWalk at BlogCatalog's size: {b['vertices']:,} "
          f"vertices in {b['communities']} planted communities, "
          f"{b['edges']:,} edges ({b['intra']:.0%} inside); vector "
          f"{d['vector']}, window {d['window']}, walk length {d['walk']}, "
          f"{d['epochs']} epoch (one walk a vertex an epoch), hierarchical "
          f"softmax on the card")
    if not native_ops.available():
        raise SystemExit("33(a): the native pair generator did not build")
    t0 = time.perf_counter()
    g, comm = gs_planted_partition(Graph, b["vertices"], b["edges"],
                                   b["communities"], b["intra"], b["seed"])
    graph_s = time.perf_counter() - t0
    degrees = np.array([g.degree(v) for v in range(g.num_vertices())])
    if int(degrees.sum()) != 2 * b["edges"]:
        raise SystemExit(f"33(a): {degrees.sum()} edge ends, not "
                         f"{2 * b['edges']}")

    class TimedWalks(RandomWalkIterator):
        """The walks `fit(graph, walk_length)` draws (the same iterator and
        seed), each walk's host time and length noted."""

        def __init__(self, *args, **kw):
            self.walk_s, self.lengths = 0.0, []
            super().__init__(*args, **kw)

        def next(self):
            t0 = time.perf_counter()
            walk = super().next()
            self.walk_s += time.perf_counter() - t0
            self.lengths.append(len(walk))
            return walk

    dw = (DeepWalk.Builder().vector_size(d["vector"])
          .window_size(d["window"]).seed(d["seed"]).epochs(d["epochs"])
          .device("cuda").build())
    walks_it = TimedWalks(g, d["walk"], seed=d["seed"])
    with _gs_counted_learners() as seen:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dw.fit(walks_it)                # the vocab's pass, then an epoch's
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    (pairs, flushes), = seen
    passes = 1 + d["epochs"]
    if walks_it.lengths != [d["walk"]] * (passes * b["vertices"]):
        raise SystemExit("33(a): bad walks")
    walk_s = walks_it.walk_s / passes
    head = RandomWalkIterator(g, d["walk"], seed=d["seed"])
    walks = [head.next() for _ in range(128)]
    W = dw._sv.get_word_vector_matrix()
    if W.shape != (b["vertices"], d["vector"]) or not np.isfinite(W).all() \
            or not np.isfinite(dw._sv.lookup.syn1).all():
        raise SystemExit(f"33(a): bad tables {W.shape}")
    rng = np.random.default_rng(q["seed"])
    probes = rng.choice(b["vertices"], q["probes"], replace=False)
    share = float(np.mean([
        np.mean(comm[dw.verticesNearest(int(v), q["top"])] == comm[v])
        for v in probes]))
    chance = 1.0 / b["communities"]
    traced = gs_traced_flush(dw, walks)
    out = {"graph_s": graph_s, "walk_s": walk_s,
           "walk_share_of_fit": passes * walk_s / fit_s, "fit_s": fit_s,
           "pairs": pairs, "flushes": flushes, "pairs_per_s": pairs / fit_s,
           "mean_degree": float(degrees.mean()),
           "same_community_share": share, "chance": chance,
           "over_chance": share / chance, "traced_flush": traced}
    print(f"  graph {graph_s:.1f} s (mean degree {out['mean_degree']:.1f}); "
          f"walks {walk_s:.2f} s a pass on the host ({b['vertices']:,} x "
          f"{d['walk']}); fit {fit_s:.2f} s, its {passes} walk passes "
          f"{out['walk_share_of_fit']:.1%} of it: "
          f"{pairs:,} pairs in {flushes} flushes, "
          f"{out['pairs_per_s']:,.0f} pairs/s")
    print(f"  one traced flush of {traced['pairs']} pairs (codes up to "
          f"{traced['code_length']}): {traced['device_ms']:.3f} ms of "
          f"device time in {traced['wall_ms']:.3f} ms (busy "
          f"{traced['busy_share']:.1%}; trace attempts "
          f"{traced['attempts']})")
    print(f"  quality: over {q['probes']} seeded vertices, "
          f"{share:.3f} of the {q['top']} nearest share the vertex's "
          f"community, {out['over_chance']:.1f}x chance ({chance:.4f}; "
          f"pin {q['over_chance']:.0f}x)")
    if not share >= q["over_chance"] * chance:
        raise SystemExit("33(a): DeepWalk's neighbourhoods miss the "
                         "communities")
    return out


def gs_deepwalk_card_vs_cpu(work):
    """33(a'): a small DeepWalk, card against CPU (1e-5), card against
    card (bit for bit), and save -> load. Returns its readings."""
    import numpy as np

    from deeplearning4j_tpu_torch.graph import DeepWalk, Graph
    s = GS_SMALL
    print(f"phase 33(a'): DeepWalk card vs CPU: {s['vertices']} vertices in "
          f"{s['communities']} communities, {s['edges']} edges, vector "
          f"{s['vector']}, walk length {s['walk']}, window {s['window']}, "
          f"{s['epochs']} epochs")
    g, _ = gs_planted_partition(Graph, s["vertices"], s["edges"],
                                s["communities"], s["intra"], s["seed"])

    def fit(device):
        return (DeepWalk.Builder().vector_size(s["vector"])
                .window_size(s["window"]).seed(s["seed"]).epochs(s["epochs"])
                .device(device).build().fit(g, walk_length=s["walk"]))
    card, cpu, again = fit("cuda"), fit("cpu"), fit("cuda")
    out = {}
    for name in ("syn0", "syn1"):
        a = getattr(card._sv.lookup, name)
        out[f"{name}_max_abs_err"] = _max_err(a, getattr(cpu._sv.lookup,
                                                         name))
        _check(f"33(a') {name} card vs CPU", out[f"{name}_max_abs_err"],
               GS_TOL)
        if not np.array_equal(a, getattr(again._sv.lookup, name)):
            raise SystemExit(f"33(a'): two card fits' {name} differ")
    path = str(work / "deepwalk.json")
    card.save(path)
    back = DeepWalk.load(path)
    for v in range(s["vertices"]):
        if not np.array_equal(back.get_vertex_vector(v),
                              card.get_vertex_vector(v)):
            raise SystemExit(f"33(a'): vertex {v} changed through the file")
    print("  two card fits bit-equal; save -> load returns every vector")
    return out


def _gs_collect(sub, n, pipe):
    """n messages from `sub`; raises the pipeline's own error if it
    stopped."""
    got, deadline = [], time.monotonic() + GS_COLLECT_TIMEOUT_S
    while len(got) < n:
        if pipe._error is not None:
            raise pipe._error
        if time.monotonic() > deadline:
            raise SystemExit(f"33: {len(got)} of {n} messages in "
                             f"{GS_COLLECT_TIMEOUT_S} s")
        p = sub.get(timeout=0.01)
        if p is not None:
            got.append((time.perf_counter(), p))
    return got


@contextlib.contextmanager
def _gs_deterministic():
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = det


def gs_lenet_pipelines():
    """33(b), pinned: LeNet f32 (configuration #1) at batch 64 through
    both pipelines against the same work on the main thread, under cuDNN's
    deterministic algorithms. Returns its readings."""
    import numpy as np

    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    from deeplearning4j_tpu_torch.streaming import (
        InMemoryBroker, StreamingInferencePipeline, StreamingTrainingPipeline,
        serde)
    print(f"phase 33(b): the streaming pipelines: LeNet f32, {GS_BATCHES} "
          f"batches of 64 through a StreamingTrainingPipeline (score topic) "
          f"and a StreamingInferencePipeline on an InMemoryBroker, against "
          f"the same fits and outputs on the main thread")
    batches = _par_batches(GS_BATCHES, 64, seed=334)
    out = {}
    with _gs_deterministic():
        streamed = lenet(device="cuda", data_type="float32")
        looped = lenet(device="cuda", data_type="float32")
        if not np.array_equal(streamed.params(), looped.params()):
            raise SystemExit("33(b): two LeNets from one seed differ")
        broker = InMemoryBroker()
        scores = broker.subscribe("scores")
        pipe = StreamingTrainingPipeline(streamed, broker,
                                         score_topic="scores").start()
        t0 = time.perf_counter()
        try:
            for ds in batches:
                broker.publish("train", serde.encode_dataset(ds))
            got = _gs_collect(scores, len(batches), pipe)
        finally:
            pipe.stop()
        out["train_s"] = time.perf_counter() - t0
        streamed_scores = [float(np.frombuffer(p, np.float64)[0])
                           for _, p in got]
        loop_scores = []
        for ds in batches:
            looped.fit(ds)
            loop_scores.append(looped.score())
        out["score_max_abs_err"] = _max_err(streamed_scores, loop_scores)
        out["params_max_abs_err"] = _max_err(streamed.params(),
                                             looped.params())
        if pipe.batches_fit != len(batches) or \
                streamed.conf.iteration_count != len(batches):
            raise SystemExit(f"33(b): {pipe.batches_fit} batches fit")
        _check(f"33(b) training pipeline's {GS_BATCHES} scores vs the "
               f"loop's",
               out["score_max_abs_err"], GS_TOL)
        _check("33(b) parameters after the pipeline vs after the loop",
               out["params_max_abs_err"], GS_TOL)
        out["scores"] = [streamed_scores[0], streamed_scores[-1]]

        preds = broker.subscribe("predictions")
        pipe = StreamingInferencePipeline(streamed, broker).start()
        t0 = time.perf_counter()
        try:
            for ds in batches:
                broker.publish("features", serde.encode_array(ds.features))
            got = _gs_collect(preds, len(batches), pipe)
        finally:
            pipe.stop()
        out["infer_s"] = time.perf_counter() - t0
        err = 0.0
        for (_, p), ds in zip(got, batches):
            rows = serde.decode_array(p)
            if rows.shape != (64, 10):
                raise SystemExit(f"33(b): prediction of shape {rows.shape}")
            err = max(err, _max_err(rows, streamed.output(ds.features)))
        out["output_max_abs_err"] = err
        _check("33(b) inference pipeline's rows vs output()", err, GS_TOL)
    print(f"  training pipeline {out['train_s']:.2f} s for {GS_BATCHES} "
          f"batches (score {out['scores'][0]:.4f} -> "
          f"{out['scores'][1]:.4f}); inference pipeline "
          f"{out['infer_s']:.2f} s")
    return out


class _GsTimedModel:
    """A model proxy for the inference pipeline: the start and end of each
    `output` call, on the host's clock (output returns numpy, so the card
    has finished)."""

    def __init__(self, net):
        self.net, self.calls = net, []

    def output(self, x):
        t0 = time.perf_counter()
        out = self.net.output(x)
        self.calls.append((t0, time.perf_counter()))
        return out


def _gs_timed_broker():
    """An InMemoryBroker that notes, by topic, when its subscriptions hand
    out a payload and when each publish starts and ends."""
    from deeplearning4j_tpu_torch.streaming import InMemoryBroker

    class TimedBroker(InMemoryBroker):
        def __init__(self):
            super().__init__()
            self.handed, self.published = {}, {}

        def publish(self, topic, payload):
            t0 = time.perf_counter()
            super().publish(topic, payload)
            self.published.setdefault(topic, []).append(
                (t0, time.perf_counter()))

        def subscribe(self, topic):
            sub, handed = super().subscribe(topic), []
            get = sub.get
            self.handed[topic] = handed

            def timed_get(timeout=None):
                p = get(timeout)
                if p is not None:
                    handed.append(time.perf_counter())
                return p
            sub.get = timed_get
            return sub

    return TimedBroker()


def gs_resnet_pipeline():
    """33(b), timed: ResNet-50 bf16 at batch 32, 224x224x3, through the
    inference pipeline, per payload the ms to decode, to run `output`, to
    encode and to publish, and images/s. Not pinned: across threads cuDNN
    picks its plans per thread. Returns its readings."""
    import numpy as np

    from concurrent.futures import ThreadPoolExecutor

    from deeplearning4j_tpu_torch.models.zoo.resnet import resnet50
    from deeplearning4j_tpu_torch.streaming import (StreamingInferencePipeline,
                                                    serde)
    r = GS_RESNET
    print(f"phase 33(b): ResNet-50 bf16 through the inference pipeline: "
          f"{r['payloads']} payloads of {r['batch']} x 224x224x3 f32 (npz)")
    net = resnet50(device="cuda", data_type="bfloat16")
    rng = np.random.default_rng(r["seed"])
    xs = [rng.random((r["batch"], 224, 224, 3), dtype=np.float32)
          for _ in range(r["payloads"])]

    def encode(x):          # zlib lets go of the GIL: one thread a payload
        t0 = time.perf_counter()
        return serde.encode_array(x), 1e3 * (time.perf_counter() - t0)

    with ThreadPoolExecutor(len(xs)) as pool:
        encoded = list(pool.map(encode, xs))
    payloads = [p for p, _ in encoded]
    encode_in_ms = statistics.median(ms for _, ms in encoded)
    broker, model = _gs_timed_broker(), _GsTimedModel(net)
    preds = broker.subscribe("predictions")
    pipe = StreamingInferencePipeline(model, broker).start()
    try:
        t_first = time.perf_counter()
        for p in payloads:
            broker.publish("features", p)
        got = _gs_collect(preds, len(payloads), pipe)
    finally:
        pipe.stop()
    handed = broker.handed["features"]
    pubs = broker.published["predictions"]
    split = []
    for i, (_, p) in enumerate(got):
        rows = serde.decode_array(p)
        if rows.shape != (r["batch"], 1000) or not np.isfinite(rows).all():
            raise SystemExit(f"33(b): ResNet-50 rows {rows.shape}, finite "
                             f"{np.isfinite(rows).all()}")
        (o0, o1), (p0, p1) = model.calls[i], pubs[i]
        split.append({"decode_ms": 1e3 * (o0 - handed[i]),
                      "output_ms": 1e3 * (o1 - o0),
                      "encode_ms": 1e3 * (p0 - o1),
                      "publish_ms": 1e3 * (p1 - p0)})
    wall = got[-1][0] - t_first
    steady = got[-1][0] - got[0][0]
    out = {"payload_mb": len(payloads[0]) / 2 ** 20,
           "client_encode_ms": encode_in_ms, "per_payload": split,
           "images_per_s": r["batch"] * len(payloads) / wall,
           "images_per_s_after_first": r["batch"] * (len(payloads) - 1)
           / steady}
    for key in ("decode_ms", "output_ms", "encode_ms", "publish_ms"):
        out[f"median_{key}"] = statistics.median(s[key] for s in split[1:])
    print(f"  payload {out['payload_mb']:.1f} MiB, each encoded by the "
          f"client in {encode_in_ms:.1f} ms (median, a thread each); the "
          f"first pays cuDNN's plans on the worker's new thread")
    for i, row in enumerate(split):
        print(f"    payload {i}: " + ", ".join(f"{k[:-3]} {v:.2f} ms"
                                               for k, v in row.items()))
    print("  median after the first: " + ", ".join(
        f"{k[:-3]} {out[f'median_{k}']:.2f} ms" for k in split[0])
        + f"; {out['images_per_s']:.1f} images/s over all "
        f"{len(payloads)}, {out['images_per_s_after_first']:.1f} after "
        f"the first; every row finite, [{r['batch']}, 1000]")
    return out


def gs_object_store_fit(work):
    """33(c), first half: `fit(ObjectStoreDataSetIterator)` on the card
    against a fit over the same DataSets held in memory. Returns its
    readings."""
    import numpy as np

    from deeplearning4j_tpu_torch.cloud import (LocalFSObjectStore,
                                                ObjectStoreDataSetIterator)
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    from deeplearning4j_tpu_torch.streaming import serde
    print(f"phase 33(c): {GS_STORE_BATCHES} LeNet DataSets of 64 in a "
          f"LocalFSObjectStore; fit over ObjectStoreDataSetIterator vs over "
          f"the same DataSets in memory")
    store = LocalFSObjectStore(str(work / "store"))
    batches = _par_batches(GS_STORE_BATCHES, 64, seed=335)
    for i, ds in enumerate(batches):
        store.put(f"lenet/batch_{i:03d}.npz", serde.encode_dataset(ds))
    with _gs_deterministic():
        from_store = lenet(device="cuda", data_type="float32")
        in_memory = lenet(device="cuda", data_type="float32")
        t0 = time.perf_counter()
        from_store.fit(ObjectStoreDataSetIterator(store, "lenet/"))
        torch.cuda.synchronize()
        store_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        in_memory.fit(ListDataSetIterator(batches))
        torch.cuda.synchronize()
        memory_s = time.perf_counter() - t0
    if from_store.conf.iteration_count != GS_STORE_BATCHES:
        raise SystemExit(f"33(c): {from_store.conf.iteration_count} steps")
    if not (np.array_equal(from_store.params(), in_memory.params())
            and from_store.score() == in_memory.score()):
        raise SystemExit(f"33(c): the object-store fit differs from the "
                         f"in-memory fit by "
                         f"{_max_err(from_store.params(), in_memory.params())}")
    print(f"  bit-equal after {GS_STORE_BATCHES} steps (score "
          f"{from_store.score():.6f}); {store_s:.2f} s from the store, "
          f"{memory_s:.2f} s from memory")
    return {"store_s": store_s, "memory_s": memory_s,
            "objects": len(store.list_keys("lenet/"))}


def gs_rank_iterator():
    """The iterator factory of 33(c)'s provisioned ranks
    (`--iterator-factory chip_smoke:gs_rank_iterator`): GS_MAIN_STEPS
    global batches of 64 LeNet images. It prints the process group the
    rank joined, which 33(c) reads."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    joined = dist.is_available() and dist.is_initialized()
    print(f"phase33c rank {dist.get_rank() if joined else 0} world "
          f"{dist.get_world_size() if joined else 1}", flush=True)
    return ListDataSetIterator(_par_batches(GS_MAIN_STEPS, 64, seed=336))


def _gs_free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gs_provision_start(work):
    """33(c), started: ClusterProvisioner's launch commands for two hosts
    (both this one) start `python -m deeplearning4j_tpu_torch.parallel.
    main` as two ranks through LocalCommandRunner, each in a thread of its
    own. Returns what gs_provision_check needs."""
    import shlex

    from deeplearning4j_tpu_torch.cloud import (ClusterProvisioner,
                                                ClusterSpec,
                                                LocalCommandRunner)
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    from deeplearning4j_tpu_torch.util import model_serializer as ms
    root = Path(__file__).resolve().parent
    src, dst = work / "lenet.zip", work / "trained.zip"
    ms.write_model(lenet(device="cuda", data_type="float32"), str(src))
    path = os.pathsep.join([str(root)] + [p for p in os.environ.get(
        "PYTHONPATH", "").split(os.pathsep) if p])
    spec = ClusterSpec(["127.0.0.1", "127.0.0.1"],
                       coordinator_port=_gs_free_port(),
                       env={"PYTHONPATH": path})
    prov = ClusterProvisioner(spec,
                              runner_factory=lambda h: LocalCommandRunner())
    worker = " ".join(shlex.quote(a) for a in (
        sys.executable, "-m", "deeplearning4j_tpu_torch.parallel.main",
        "--model-path", str(src), "--iterator-factory",
        "chip_smoke:gs_rank_iterator", "--epochs", "1",
        "--model-output-path", str(dst), "--report-score",
        "--device", "cuda"))
    launches = prov.launch_commands(worker)
    results = [None] * len(launches)

    def run(i, host, command):
        try:     # exec: the shell becomes the rank, so a timeout kills it
            results[i] = prov.runner_factory(host).run(
                "exec " + command, timeout=GS_MAIN_TIMEOUT_S)
        except Exception as e:                      # noqa: BLE001
            results[i] = (None, f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(i, h, c), daemon=True)
               for i, (h, c) in enumerate(launches)]
    for t in threads:
        t.start()
    return {"threads": threads, "results": results, "launches": launches,
            "src": src, "dst": dst, "t0": time.perf_counter()}


def gs_provision_check(started):
    """33(c), finished: both ranks exit 0 and report world 2; rank 0's zip
    restores with finite parameters after GS_MAIN_STEPS steps."""
    import numpy as np

    from deeplearning4j_tpu_torch.util import model_serializer as ms
    for t in started["threads"]:
        t.join(GS_MAIN_TIMEOUT_S + 30)
    wall_s = time.perf_counter() - started["t0"]
    results = started["results"]
    for rank, res in enumerate(results):
        rc, text = res if res is not None else (None, "no result")
        if rc != 0:
            raise SystemExit(f"33(c): rank {rank} exited {rc}: "
                             f"{text[-3000:]}")
        if f"phase33c rank {rank} world 2" not in text:
            raise SystemExit(f"33(c): rank {rank} did not join a world of "
                             f"2: {text[-3000:]}")
    launch = " ".join(w for w in started["launches"][1][1].split()
                      if w.split("=", 1)[0] in ("MASTER_ADDR", "MASTER_PORT",
                                                "RANK", "WORLD_SIZE"))
    net = ms.restore_model(str(started["dst"]), device="cuda")
    p = net.params()
    if not np.all(np.isfinite(p)) or \
            net.conf.iteration_count != GS_MAIN_STEPS:
        raise SystemExit(f"33(c): rank 0's zip: finite "
                         f"{np.all(np.isfinite(p))}, "
                         f"{net.conf.iteration_count} iterations")
    score = [l for l in results[0][1].splitlines() if l.startswith("epoch")]
    print(f"  two provisioned parallel.main ranks (rank 1's launch: "
          f"{launch}): both exit 0 in a world of 2, {wall_s:.1f} s with their "
          f"start; rank 0's zip restores after {GS_MAIN_STEPS} steps, "
          f"parameters finite ({score[-1] if score else 'no score'})")
    return {"wall_s": wall_s, "iterations": net.conf.iteration_count}


def gs_device_free():
    """33(d): one call of each device-free module of the slice on the
    card's machine, on the committed fixtures. Returns the counts."""
    from deeplearning4j_tpu_torch.text import (
        InMemoryInvertedIndex,
        JapaneseLatticeTokenizerFactory, KoreanMorphTokenizerFactory,
        PerceptronChunker, PerceptronPosTagger, TfidfVectorizer,
        porter_stem, standard_pipeline)
    from deeplearning4j_tpu_torch.text.treeparser import TreeParser
    fix = Path(__file__).resolve().parent / "tests" / "fixtures"
    print("phase 33(d): the device-free modules on the card's machine")
    ja = JapaneseLatticeTokenizerFactory(
        dict_path=str(fix / "ja_dict"),
        user_dict_path=str(fix / "ja_dict" / "userdict.txt")).create(
            "関西国際空港に行った").get_tokens()
    ko = KoreanMorphTokenizerFactory(dict_path=str(fix / "ko_dict")).create(
        "바다는 넓다").get_tokens()
    pos = str(fix / "pos_model.json.gz")
    tags = PerceptronPosTagger.load(pos).tag(
        "the quick dog chased a ball .".split())
    chunks = PerceptronChunker.load(str(fix / "chunk_model.json.gz")).tag(
        tags)
    tree = TreeParser(pos_model=pos).get_trees(
        "The quick dog chased a small cat.")[0].to_string()
    doc = standard_pipeline(pos_model=pos).process(
        "The runners were running quickly. It was a beautiful day.")
    stems = [porter_stem(w) for w in ("running", "generalizations",
                                      "relational")]
    docs = ["the cat sat on the mat", "the dog sat", "a cat and a dog"]
    tfidf = TfidfVectorizer().fit_transform(docs)
    index = InMemoryInvertedIndex()
    for d in docs:
        index.append(d.split())
    index.finish()
    hits = index.documents("cat")
    want = {"ja": ["関西", "国際", "空港", "に", "行った"],
            "ko": ["바다", "는", "넓", "다"], "hits": [0, 2],
            "stems": ["run", "gener", "relat"]}
    got = {"ja": ja, "ko": ko, "hits": hits, "stems": stems}
    if got != want or dict(tags)["chased"] != "VBD" or \
            chunks[0][1] != "B-NP" or "(VP" not in tree or \
            tfidf.shape != (3, 8):
        raise SystemExit(f"33(d): {got}, tags {tags}, chunks {chunks}, "
                         f"tree {tree}, tf-idf {tfidf.shape}")
    counts = {"ja_tokens": len(ja), "ko_tokens": len(ko),
              "tags": len(tags), "chunks": len(chunks),
              "annotations": len(doc._annotations),
              "tfidf_shape": list(tfidf.shape),
              "index_documents": index.num_documents(), "cat_hits": hits}
    print(f"  Japanese {ja} (user dictionary), Korean {ko}, {len(tags)} "
          f"tags and chunks, tree {tree}, {counts['annotations']} "
          f"annotations, stems {stems}, TF-IDF {tfidf.shape}, index hits "
          f"for 'cat' {hits}")
    return counts


def graph_stream_phase(fa):
    """Phase 33. Returns its readings. Nothing of the slice reaches a
    kernel of the port: the counters are set to 0 first and must read 0
    after it."""
    import tempfile
    t_phase = time.perf_counter()
    fa.reset_launches()
    out = {"card": card_line(),
           "sub_phase_s": {}}
    print(f"phase 33: graph embeddings, streaming and object-store training "
          f"({out['card']})")
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase33_", dir=str(build)))
    started = None
    try:
        t = time.perf_counter()
        out["a"] = gs_deepwalk_full()
        out["sub_phase_s"]["a"] = time.perf_counter() - t
        # (c)'s two ranks run in their own processes while the untimed
        # parts run here; ResNet-50's timed pipeline waits for them
        started = gs_provision_start(work)
        for key, fn in (("a_card_vs_cpu", gs_deepwalk_card_vs_cpu),
                        ("b", lambda _: gs_lenet_pipelines()),
                        ("c", gs_object_store_fit),
                        ("d", lambda _: gs_device_free())):
            t = time.perf_counter()
            out[key] = fn(work)
            out["sub_phase_s"][key] = time.perf_counter() - t
        t = time.perf_counter()
        out["c"]["provisioned"] = gs_provision_check(started)
        out["sub_phase_s"]["c_wait"] = time.perf_counter() - t
        t = time.perf_counter()
        out["b"]["resnet50"] = gs_resnet_pipeline()
        out["sub_phase_s"]["b_resnet50"] = time.perf_counter() - t
    finally:
        if started is not None:
            for th in started["threads"]:
                th.join(GS_MAIN_TIMEOUT_S + 30)
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    launched = dict(fa.launches)
    if any(launched.values()):
        raise SystemExit(f"phase 33 launched flash kernels: {launched}")
    out["flash_launches"] = launched
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 33 launched no kernel of the port: {launched}; "
          f"{out['phase_s']:.1f} s ({out['sub_phase_s']})")
    return out


if __name__ == "__main__":
    sys.exit(main())
