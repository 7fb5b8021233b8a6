#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. device   — needs a CUDA device; prints the card's name and power limit
              and turns TF32 off for matmul and cuDNN;
2. build    — compiles every kernel of the port (SpMM, flash attention,
              SSD) from the checkout's sources in one build
              (``build/torch_kernels/``) and prints the seconds;
3. spmm     — the nonzero-balanced SpMM kernel, on the compressed arrays
              ``block_sparse_plan_dev`` derives from each plan's tiles,
              against the plain version on the dense tiles (``spmm_ref``):
              bs ∈ {32, 64, 128} × d ∈ {8, 41, 128, 200} on rectangular
              plans, forward and transposed; a skewed plan (one row of
              5 000 nonzeros over 79 warp segments, 500 empty rows, rows
              straddling segments) whose repeat launches must be bitwise
              equal, in fp32 and with a bf16 h; the naive path's layer-0
              width (d=602) and a plan of
              the DP path's shape (local rows × local rows + a halo row);
              a stacked plan's padded instance; an empty plan (no
              launch, zeros); and forward + autograd backward through
              ``aggregate_plan`` against the plain version on its arrays;
              each case held to max|Δ| ≤ 1e-5·(1 + max|ref|).  The
              one-shot entry points: ``aggregate_pallas`` on a
              ``block_sparse_dev`` (one launch a call) at bs ∈ {32, 64,
              128} × d ∈ {8, 41, 128}, n not a multiple of bs, with fp32
              tiles and tiles rounded through bf16, against the plain
              version and (fp32 tiles) the dense oracle; a bf16 h at d ∈
              {41, 128, 602}, held per element to |Δ| ≤ 2^-7·|ref| + 1e-3
              (both round one fp32 sum once); ``square_plan_dev`` forward
              and autograd backward (two launches); the refusal of a
              gradient through a ``BlockSparseDev`` (no launch).  Then
              the one-shot path at the reference kernel bench's micro
              shape (``sbm_power_law(n=4096, num_classes=8,
              feat_dim=128, avg_degree=16, seed=7)``, bs 128, d 128):
              ``block_sparse_dev``'s derivation timed once; with the
              counts zeroed just before and read just after, per dtype
              of h (fp32, bf16) one ``aggregate_pallas`` on the
              ``BlockSparseDev`` and a forward and backward through the
              square plan — 3 launches a dtype — held against the plain
              version, the one-shot product bitwise the plan's forward;
              each dtype's call timed (device time) beside its CUDA-event
              time, the plain version, ``torch.sparse.mm`` on torch's CSR
              of the tiles (bf16 values for a bf16 h) and its bound;
4. flash    — the flash-attention kernels against their plain version:
              every bf16 case through the bf16 kernel and every fp32 case
              through the three-pass TF32 kernel (launch counts per
              variant), GQA
              groups g ∈ {1, 2, 4, 8}, causal and not, window, softcap,
              ragged Sq ≠ Skv, hd ∈ {36, 64, 80, 128, 192, 256}, hdv ≠ hd,
              gemma2's local layer cut to 4 heads (hd 256, g=2, window
              4096, softcap 50, 4608 tokens: past the window), MLA's
              hd 192 / hdv 128 and InternVL2's GQA 14/2 (g=7) at hd 64
              over 2 304 tokens, each in both dtypes; fp32
              held to 1e-5·(1 + max|ref|), bf16 per element to |Δ| ≤
              2^-7·|ref| + 1e-3 (both round the same fp32 math to bf16
              once, so they differ by at most one bf16 ulp); a NaN (the
              card's canonical bits) planted in one query row and in one
              key row of an fp32 case appears exactly where the plain
              version puts NaN, and the rest is held as the other cases;
5. ssd      — the SSD intra-chunk kernel against its plain version:
              Q ∈ {16, 64, 96, 256, 1024}, P ∈ {20, 30, 32, 64}, N ∈ {32,
              38, 40, 64, 128}, H > 1 with B/C shared, the path's widths
              (H=80, P=N=64, Q=256) and H=13, not a multiple of the
              kernel's head group, and x, B, C off 16-byte alignment (the
              kernel's 4-byte copies); held to 1e-4·(1 + max|ref|) (the
              kernel's prefix sum adds in another order; exp(cs) at |cs|
              ~ 1e2); a NaN (the card's canonical bits) planted in x and
              in dt reaches every output that depends on it, and no
              output the plain version keeps finite; and the full
              ``ssd_chunked_fused`` against ``ssd_chunked`` and
              ``ssd_dense_ref`` with S not a multiple of Q;
6. gcn      — the GCN main path: decoupled-pipelined TP GCN training on
              reddit_like(scale=1.0, seed=0) (n=23 000, 602 features, 41
              classes; hidden 128, 2 layers, 4 chunks, blocksparse at
              bs=128, AdamW lr 1e-2 wd 5e-4) over a 1-rank NCCL group:
              3 warm-up + 10 timed steps with finite, falling loss and 16
              SpMM launches a step; one step profiled (device busy, idle
              share); one more step's collective ledger held to the
              schedule (16 all-to-alls, 8 forward and 8 backward, payload
              from the shapes, one loss psum of 12 bytes, one gradient
              all-reduce of the parameters' bytes, 0 wire bytes at N=1)
              and audited: the collectives the step issued, counted by
              ``torch.profiler`` below the choke point
              (``analysis/audit.py``: 8 all-to-alls forward and 8 backward,
              the backward's on autograd's own thread, and 2 all-reduces),
              held against the ledger with no finding and printed;
              then the step-0 loss and grads recomputed with the plain
              version on the card and with the segment backend, each held
              within rtol 1e-4 (per tensor, max|Δ| ≤ 1e-4·max|ref|);
7. naive    — the same, with ``mode="naive"`` on phase 6's bundle: a
              split, one aggregation round and a gather per layer; 12 SpMM
              launches a step (layer 0 forward only, its input features
              carry no gradient; layer 1 forward and backward) and
              4L−2 = 6 all-to-alls, the ledgered step audited as phase 6's
              (phases 10–11 and 13 too);
8. dp       — the same for the DP halo-exchange baseline,
              ``prepare_dp_bundle(k=1, agg="blocksparse")`` and
              ``make_dp_train_fns`` on the same graph: 3 SpMM launches a
              step on the rectangular per-worker plan and L+(L−1) = 3 halo
              all-to-alls, the step audited; the kernel held against the
              plain version on that plan at both layers' widths;
9. stream   — the out-of-core streamed step (``core.stream``) on the same
              graph: ``prepare_stream_bundle(n_chunks=4, n_stripes=16,
              agg="blocksparse", bs=128)`` keeps the features (16× a
              stripe) and the chunks' half plans (compressed rows, built
              on the host) in pinned host memory; each step stages the
              stripes and chunk inputs on a copy stream, two at a time.
              Beside it the in-memory ``decoupled`` step on the same
              padded vertices (whose card-derived compressed rows must be
              bitwise the host half plans).  Held: 3 warm-up + 10 timed
              steps, finite and falling loss, 16 SpMM launches a step (8
              on the half plans, 8 on the transposed ones); one step's
              h2d entries equal ``expected_h2d_bytes`` and its collective
              entries the in-memory step's; step-0 loss and grads within
              rtol 1e-4 of the plain version, the streamed segment backend
              and the in-memory step; two steps from the same params
              bitwise equal; 8 pinned buffers through ``prefetched`` under
              a slow consumer and a slow producer keep their checksums;
              on a circulant graph at V = 23 040, 46 080 and 92 160 (16,
              32 and 64 chunks and stripes, segment backend) the staged
              bytes are equal and the measured peak less its five (V, C)
              buffers equal within 256 KiB.  Printed: both steps'
              medians, h2d MB a step, the link's GB/s over the copies'
              device time beside a pinned 256 MB copy (the ceiling), the
              overlap share (copy time under a kernel on the compute
              stream), device busy and idle share, the path's bound (max
              of h2d at the ceiling and the in-memory step's device busy)
              and both steps' peak memory;
10. gat     — GAT under decoupled-pipelined TP on phase 6's bundle and
              widths (the paper's generalized decoupling): each rank scores
              its own vertices and shares the two (V/N,) score halves by an
              all-gather; attention α is a segment softmax over the in-edges
              and the aggregation segment sums, whatever the bundle's
              backend.  Held: 3 warm-up + 10 timed steps, finite and falling
              loss, 0 SpMM launches; one step profiled; one step's ledger
              (16 all-to-alls, 8 forward and 8 backward, and 4 all-gathers,
              2 + 2, of 4·V bytes each); step-0 loss and grads within rtol
              1e-4 of the unpipelined ``decoupled`` mode and of the
              single-device ``decoupled_forward`` and loss on the card;
11. gat-naive — the same with ``mode="naive"``: per layer ``h @ w``, the
              score all-gathers, α, a split, the aggregation and a gather;
              every all-to-all moves ``h @ w``, so 8 all-to-alls and 8
              all-gathers a step; step-0 held against the port's
              single-device ``coupled_forward`` on the card;
12. sage, gin — SAGE and GIN decoupled-pipelined on phase 6's blocksparse
              bundle (γ·Â propagation): each 3 warm-up + 10 timed steps
              with finite, falling loss and 16 SpMM launches a step, one
              step profiled; step-0 loss and grads against the plain
              version and the segment backend, rtol 1e-4 (GIN's ``eps``
              gets zero gradients, as under JAX);
13. hybrid  — hybrid DP×TP on ``hybrid_mesh(model=1, data=1)`` over the
              1-rank NCCL world (model and data subgroups of one rank):
              GCN decoupled-pipelined and naive on phase 6's bundle (its
              padding is the hybrid one at one replica), the DP baseline
              from ``prepare_dp_bundle(mesh=...)`` (k=1, n_replicas=1) and
              GAT decoupled-pipelined, each 3 warm-up + 5 timed steps with
              finite, falling loss and 16 / 12 / 3 / 0 SpMM launches a
              step, one step profiled; one step's ledger equal to the
              pure-TP step's of phases 6, 7, 8 and 10 with its gradient
              all-reduce keyed ``model+data`` and the data-axis entries
              added (the replica all-gathers, 1 / 2 / 2 / 1 forward and 1
              backward each, payload from the shapes; one stacked loss
              psum of 12 bytes; 0 wire bytes); step-0 loss and grads
              within rtol 1e-6 of the pure-TP path, the largest
              difference printed;
14. constraint — the constraint engine backend (``backend="constraint"``:
              global-view DTensor programs, every layout transition run
              through ``runtime/collectives.py``, DTensor's own
              collectives only the loss and gradient all-reduces) on six
              paths, each beside its explicit twin in the same phase (3
              warm-up + 5 timed steps each, one step profiled): GCN
              decoupled (``decoupled_pipelined`` is its alias: its step-0
              and ledger equal decoupled's, 4 all-to-alls a step), GCN
              naive, DP (k=1), GAT decoupled, the streamed epoch (phase
              9's bundle) and GCN decoupled on ``hybrid_mesh(1, 1)``.
              Held: 16 / 12 / 3 / 0 / 16 / 16 SpMM launches a step; one
              step's all-to-all, all-gather and h2d entries equal to the
              explicit twin's, and no psum or grad_psum entries (those
              reductions are DTensor's), each backend's step audited (the
              streamed epoch's with both passes together: it runs its
              split's transpose by hand); step-0 loss and grads within
              rtol 1e-6 of the twin's under deterministic algorithms; a
              ``CommDebugMode`` census of one step (forward and the
              reductions: the backward runs on autograd's thread, which
              the mode does not see) with no DTensor collective but
              all-reduces, the counts printed (none at one rank);
15. spmm-t  — the forward and the backward chunk at the decoupled path's
              shapes and the naive path's layer-0 forward chunk (d=602):
              the kernel held against the plain version on chunk
              0's tiles and on its arrays, a repeat launch bitwise equal,
              and ``torch.sparse.mm`` on torch's CSR of the same tiles
              (held to 1e-5·(1 + max|ref|); timed only, never on the path);
              kernel and library timed as device time (``torch.profiler``,
              min of two runs of 20 after a warm-up; the SpMM's includes
              the memset of its flags, printed apart), beside the CUDA-event
              time of a call, the plain version and the bound of these
              inputs (nonzeros, row pointers, h once, output once);
16. serve   — the LM main path: Zamba2-2.7B at full width and depth
              (2.06 B parameters, random fp32 weights from seed 0 drawn on
              the card), bf16 compute, ``attn_impl="flash"``,
              ``ssm_impl="fused"``: ``generate`` of 2 prompts × 2048 tokens
              from ``SyntheticLM(32000, seed=0)`` + 32 greedy steps, 9
              flash launches in prefill (all of the tensor-core kernel)
              and none in decode; then prefill and decode timed (medians),
              one of each profiled, peak memory;
17. score   — ``forward`` + ``lm_loss`` on 2 × 2048 tokens with targets
              under ``torch.no_grad()``: 9 flash (tensor-core) and 45 SSD
              launches, a finite loss; timed and profiled;
18. fp32    — the same weights in fp32 on a 1 × 512 prompt: the kernel
              path (9 + 9 fp32 flash launches, 45 SSD) against the same
              path with both plain versions patched in on the card (no
              launch) — prefill logits within 1e-4·max|ref|, identical
              greedy tokens over 8 steps, scoring loss within 1e-5
              relative; and the bf16 scoring loss of phase 17 beside its
              plain-version twin (printed, not gated);
19. lm-t    — one bf16 flash launch at each LM path's shape, held against
              its plain version (per element, as phase 4) and timed beside
              it, the library yardstick on the same tensors — held for
              agreement to 1e-2·(1 + max|ref|) (it rounds the softmax
              weights to bf16), timed, never on the path:
              ``scaled_dot_product_attention`` (``enable_gqa``) where
              there is no softcap and no window, else the
              compiled ``flex_attention`` (the softcap its score_mod, the
              causal window its block mask, ``enable_gqa``; SDPA has no
              softcap; inductor's and Triton's caches under ``build/``) —
              and its bound: the
              bf16 operations 2·(hd + hdv) per visible pair per head at
              the tensor-core peak against q, k, v and the output once:
              Zamba2's (2, 32, 2048, 80), gemma2's global (1, 16, 8192, 256)
              g=2 softcap 50, its local layer (the same, window 4096),
              DeepSeek's MLA (2, 16, 2048, 192/128), InternVL2-1B's (2,
              14, 2304, 64) g=7 and MusicGen-large's (2, 32, 2112, 64)
              (their prefills: 256 and 64 prefix positions before 2048
              tokens); the fp32 kernel (three TF32 passes) at the shapes
              the fp32 cross-checks launch it at — Zamba2's (1, 32, 512,
              80), gemma2's global and local layers (1, 16, 4608, 256)
              g=2 softcap 50 (window 4096), MLA's (1, 16, 512, 192/128) —
              and at Zamba2's (2, 32, 2048, 80), held in fp32 and timed
              beside fp32 SDPA or, with a softcap, the compiled
              ``flex_attention`` in fp32, its bound three TF32 passes at
              the tensor-core peak (the fp32 CUDA-core figure beside);
              one SSD launch at
              Zamba2's (2, 2048, 80, 64) N=64 and at Mamba2-1.3B's (2,
              2048, 64, 64) N=128, Q=256, device time
              (``torch.profiler``) with its CUDA-event time beside, its
              plain version and its bound: bytes against three TF32
              passes of the needed operations at the tensor-core peak
              (the fp32 FMA figure printed beside).  Each flash and SSD
              row also prints the bytes its kernel's schedule requests
              (``hbm_bytes_model``) and the rate they imply at the
              measured time;
20. single  — the single-device trainer (``gnn/train.py::
              train_full_graph``, no process group) on reddit_like (phase
              6's graph), hidden 128, 2 layers, AdamW lr 1e-2 wd 5e-4: GCN,
              SAGE, GIN and GAT, each coupled and decoupled, 13 epochs
              logging each: finite and falling loss, no SpMM launch (the
              trainer aggregates by segment sums), the median epoch over
              epochs 4–13 and the peak memory printed; epoch 1's loss and
              accuracies and epoch 2's loss held within rtol 1e-4 of the
              same two epochs on the CPU from the same weights (an
              accuracy may move one vertex more: a near-tie argmax); one
              epoch profiled (device busy, idle share, top kernels).  A
              checkpoint of the trained decoupled GCN saved, restored into
              a template on the card (leaves bitwise equal, on the card)
              and its test accuracy unchanged within 1e-6.  R-GCN on
              ``heterogeneous_sbm(n=23000, num_classes=41,
              num_edge_types=4, feat_dim=602, avg_degree=64, seed=0)``,
              coupled and decoupled, the same; then decoupled-pipelined TP
              on a blocksparse bundle (bs=128, 4 chunks) over a 1-rank
              NCCL group: 3 warm-up + 10 timed steps, 16 SpMM launches a
              step, step-0 loss and grads within rtol 1e-4 of the
              single-device decoupled forward on the bundle, peak memory.
              Last, ``examples/train_gcn_full_graph_torch.py --epochs 20``
              in a process of its own: exit code 0 and its checkpoint
              line;
21. multihost — ``runtime/distributed.py`` on the card: ``initialize()``
              opens a 1-rank NCCL group; (a) phase 6's bundle through
              ``prepare_bundle(mesh=TPMesh())`` (each rank keeps its own
              rows: all of them at N=1, so its resident node-array bytes
              equal the unplaced bundle's, printed), 3 warm-up + 5 timed
              steps with 16 SpMM launches a step (and the unplaced bundle
              the same, its median printed beside), step-0 loss and grads
              within rtol 1e-6 of the unplaced bundle's under
              deterministic algorithms; a host DP bundle placed slab by
              slab (``place_dp_bundle_streamed``, 4 slabs: 20 ``h2d``
              entries) bitwise equal to ``place_dp_bundle``'s; (b) ``python
              -m repro_torch.launch.multihost`` in a child process under the
              env contract (``COORDINATOR_ADDRESS=127.0.0.1:<port>``,
              ``NUM_PROCESSES=1``, ``PROCESS_ID=0``) at phase 6's widths,
              three times (GCN decoupled-pipelined, ``--mode dp``, ``--model
              gat --backend constraint``): exit 0, one ``RESULT`` line
              with ``processes: 1``, finite and falling losses, the first
              within rtol 1e-5 of the same first step computed in this
              process from the same seed; each median epoch printed.

22. gemma2  — gemma2-9b at full width and depth (42 layers, local and
              global alternating, 9.24 B parameters, bf16 weights from seed
              0, norms fp32), ``attn_impl="flash"``: ``generate`` of 1 ×
              8192 ``SyntheticLM`` tokens (its full context, twice the
              window) + 32 greedy steps with ``long_context=True`` (ring
              caches on the local layers), then with dense caches; 42 flash
              launches per prefill, all of the tensor-core kernel, none per
              decode step; each flash launch counted by case where the
              wrapper launches it (``launches_by_case``): 21 global (hd
              256, softcap 50) and 21 local (window 4096 too) per prefill;
              prefill and decode timed (medians of 3 and 32) and profiled;
              ``forward`` + ``lm_loss`` on the same tokens: the same 21 +
              21 launches, a finite loss; peak memory of each;
23. deepseek — deepseek-v2-lite-16b at full width and depth (1 dense +
              26 MoE layers, MLA, 15.7 B parameters, bf16 weights, router
              and norms fp32): ``generate`` of 2 × 2048 + 32 steps, 27
              flash launches per prefill (hd 192 / hdv 128), none per
              decode step; the assignments MoE drops at prefill's capacity
              (T·k against E·C, each layer); scoring: 27 launches, finite
              loss and aux loss; timed and profiled;
24. mamba2  — mamba2-1.3b at full width and depth (48 mamba2 layers, N=128,
              64 heads, fp32 weights), ``ssm_impl="fused"``: scoring 2 ×
              2048, 48 SSD launches; ``generate`` 2 × 2048 + 32 steps, no
              SSD launch (the prefill runs the plain ``ssd_chunked``, as
              the reference's); timed and profiled;
25. lm-x    — phase 18's fp32 cross-check, under deterministic algorithms
              (MoE's ``index_add_`` and ``index_put_`` then sum in a fixed
              order), on gemma2 at full width and 4 layers over 1 × 4608
              tokens (past the window) with ring and with dense caches,
              DeepSeek at full width and 3 layers (1 dense + 2 MoE), Mamba2
              at full width and 4 layers, both on 1 × 512, and granite-moe,
              minitron, internlm2 and qwen1.5 reduced on 1 × 512: the kernel
              path's launches counted (fp32 flash, SSD), the plain path's 0;
26. mm      — InternVL2-1B (24 layers, GQA 14/2, 256 vision prefix
              embeddings) and MusicGen-large (48 layers, 32 heads, 64 audio
              conditioning embeddings) at full width and depth, bf16
              weights (norms fp32), ``attn_impl="flash"``: ``generate`` of 2
              × 2048 ``SyntheticLM`` tokens behind the config's prefix (its
              normal draws from ``batches(cfg=)``) + 32 greedy steps, 24 and
              48 flash launches per prefill counted by case, none per
              decode step, the caches' length P + S after prefill;
              scoring (``forward`` + ``lm_loss`` on the prefixed batch, the
              prefix positions dropped): the same launches, a finite loss;
              prefill and decode medians, one profile of each, peak memory;
27. lm-train — ``make_train_step(cfg, adamw(3e-4), remat=True)`` at full
              width and depth on the configs' defaults (naive attention,
              jnp SSD; bf16 compute over fp32 parameters): InternVL2-1B at
              train_4k's 4096 tokens behind its 256 prefix embeddings and
              Granite-MoE-1B-A400M at 4096 tokens (the MoE aux loss in the
              gradient), each at the batch one card holds (train_4k's 256
              cut: the peaks of remat=True steps at batch 1 and 2 measured
              first, the batch the largest predicted within 80 % of the
              card): 3 warm-up + 10 timed steps on fresh batches, finite
              and falling loss, finite aux, every MoE router moved, 0 flash
              and 0 SSD launches; the median step, tokens/s, MFU (6·N·T +
              12·L·H·hd·S² a sequence, over the bf16 peak), one profiled
              step, peak memory; InternVL2's peaks at remat True / False /
              ``"dots"`` at the batch remat=False fits.  The fp32
              cross-check under deterministic algorithms: both configs at
              full width cut to 2 layers on 1 × 512 tokens (+ prefix),
              step 0's loss, aux, total and every gradient leaf and two
              steps' metrics on the card within 1e-4 of the CPU's from the
              same weights and batches, remat True / False / ``"dots"``
              within 1e-6 of each other, the router's gradient nonzero.
              Last, the forward-only kernels refuse: ``make_train_step`` on
              ``attn_impl="flash"`` and on ``ssm_impl="fused"`` raises, so
              does a grad-enabled call of either wrapper on the card, and
              neither kernel launches.
28. shard   — the LM's NeutronTP sharding (``repro_torch.sharding``) on
              ``make_host_mesh(model=1, data=1)`` over a fresh NCCL group
              of one rank.  Scoring: Zamba2-2.7B at full width,
              ``forward(shard=ExplicitSharder(...))`` on phase 17's 2 ×
              2048 tokens under no_grad beside the unsharded forward — 9
              flash and 45 SSD launches in the sharded run (counts zeroed
              just before it), the logits equal (bitwise, else the
              difference printed and held within 1e-5·max|ref|), the
              ledger's calls the schedule at N = 1 (4 all-to-alls an
              attention layer, 3 and 2 all-gathers a mamba layer, the
              parameter gathers of ``param_spec``) with no wire bytes; both
              forwards timed, the sharded one profiled.  Training:
              Granite-MoE-1B-A400M, phase 27's configuration, through
              ``sharded_setup(..., ShardingRules("neutron_tp"))`` at batch
              4: step 0 under deterministic algorithms within 1e-5
              relative of the unsharded step on the same batch, 3 timed
              steps, 0 kernel launches, one step audited
              (``analysis/audit.py``, clean: the checkpoint's reruns are
              the ledger's recomputed calls) and one profiled; step ms,
              busy, idle share, peak memory.

29. shard-serve — sharded LM serving (``make_serve_fns(cfg, sharder)``)
              on ``make_host_mesh(model=1, data=1)`` over a fresh NCCL
              group of one rank: Zamba2-2.7B at full width and depth, 2 ×
              2048 prefilled and 32 greedy steps through the
              ``ExplicitSharder``'s closures beside phase 16's unsharded
              ``generate`` — identical tokens, the prefill logits bitwise
              (else within 1e-5·max|ref|), 9 flash launches in the sharded
              prefill and none in its decode steps, no wire bytes; both
              paths' prefill and decode medians, a decode step of each
              profiled.  Then fp32 at full width cut in depth, under
              deterministic algorithms: gemma2 at 4 layers on 1 × 4608
              (ring and dense caches) and DeepSeek at 3 on 1 × 512, each
              ``seq_shard_cache`` layout against the unsharded twin
              (tokens identical, logits within 1e-5·max|ref|).

30. megatron — the megatron strategy (column- and row-parallel NN
              phase, ``Sharder(mesh, ShardingRules("megatron"))``) on
              ``make_host_mesh(model=1, data=1)`` over a fresh NCCL group
              of one rank.  Zamba2-2.7B at full width, bf16 compute:
              scoring 2 × 2048 beside the unsharded forward (9 flash and
              45 SSD launches, logits bitwise, else within
              1e-5·max|ref|), and serving 2 × 2048 + 32 greedy steps
              through ``make_serve_fns(cfg, sharder)`` beside ``generate``
              (9 flash launches in the prefill, 0 a decode step, tokens
              identical, prefill logits bitwise, else within
              1e-5·max|ref|); each ledger holds the row-parallel sums
              (``tp_psum``: 109 a forward or decode step), no parameter
              gathered over the model axis and no wire byte.
              Granite-MoE-1B-A400M through ``sharded_setup(...,
              ShardingRules("megatron"))`` at batch 4: step 0 under
              deterministic algorithms (the loss bitwise, else within
              1e-5 relative; every gradient leaf within 1e-5·‖ref‖), the
              step's ``tp_psum`` calls and mirrors, two timed steps, no
              kernel launch.

31. dryrun  — ``launch/dryrun.py`` (the per-rank program on torch's
              ``fake`` process-group backend under ``FakeTensorMode``: no
              card) on mesh (data 1, model 1), in two child processes at
              once, for phase 28's Granite-MoE ``sharded_setup`` step at
              batch 4 and phase 30's megatron Zamba2 decode step: its
              ledger equal to the card's entry for entry, its argument
              bytes the bytes of the state on the card, its FLOPs those
              ``FlopCounterMode`` counted in one more real step on the
              card (phases 28 and 30 record them); the predicted peak
              beside ``torch.cuda.max_memory_allocated`` and the H100
              roofline terms beside the measured step time, recorded.

The last lines are a JSON summary of the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.  The ``kernels`` line
has one entry per kernel and shape: the SpMM on the GCN paths, the SpMM
on phase 3's one-shot path with an fp32 h and with a bf16 h (each with
its dtype's launches, ``launches_by_dtype`` beside), the flash kernel at
Zamba2's shape,
gemma2's global and local layers', MLA's, InternVL2-1B's and
MusicGen-large's, the fp32 flash kernel (three TF32 passes) at the fp32
cross-checks' (1, 32, 512, 80), at Zamba2's (2, 32, 2048, 80), at gemma2's
global and local layers' (1, 16, 4608, 256) and at MLA's (1, 16, 512,
192/128), with fp32 SDPA or ``flex_attention`` as its yardstick and the
fp32 launches of phases 18 and 25 (the first row all of them, by case
beside; the others their case's), the SSD kernel at
Zamba2's and Mamba2-1.3B's, flash and SSD again on phase 28's sharded
scoring path, flash on phase 29's sharded prefill, and flash and SSD on
phase 30's megatron scoring and serving, each with its
path's launches (each flash shape's its own
case's count from the main-path runs).
In it, ``ms_by`` says how each row's ``ms`` and ``library_ms``
were timed: ``"profiler"`` (device time from ``torch.profiler``) or
``"events"`` (CUDA events over back-to-back calls); ``plain_ms`` and the
SpMM's ``event_ms`` are always CUDA events.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_TF32_FLOP_PER_S = 495e12
KERNEL_TOL = 1e-5
BF16_ULP = 2.0 ** -7   # bf16 spacing relative to the value
BF16_ATOL = 1e-3       # per-element floor for outputs near 0
SDPA_TOL = 1e-2        # SDPA rounds the softmax weights to bf16
SSD_TOL = 1e-4         # prefix sums in another order, exp(cs) at |cs| ~ 1e2
PATH_RTOL = 1e-4
# the port's kernels, as their names appear in a profile
PORT_KERNELS = ("spmm_csr_kernel", "flash_fwd", "ssd_intra_chunk_kernel")


def _held(name: str, got: torch.Tensor, want: torch.Tensor,
          rtol: float = KERNEL_TOL, floor: float = 1.0) -> float:
    """Hold ``got`` to max|Δ| ≤ rtol·(floor + max|want|); returns max|Δ|."""
    err = (got - want).abs().max().item() if want.numel() else 0.0
    ref = want.abs().max().item() if want.numel() else 0.0
    ok = err <= rtol * (floor + ref)
    print(f"  {name:<44} max|Δ|={err:.3e}  max|ref|={ref:.3e}  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max|Δ| {err} > {rtol}·({floor}+{ref})")
    return err


def _held_bf16(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Hold a bf16 result per element, |Δ| ≤ 2^-7·|want| + 1e-3: one bf16
    ulp of the value, for two roundings of the same fp32 math.  Returns
    max|Δ|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    worst = (diff / (BF16_ULP * want.abs() + BF16_ATOL)).max().item()
    err = diff.max().item()
    ok = worst <= 1.0
    print(f"  {name:<44} max|Δ|={err:.3e}  worst |Δ|/(2^-7·|ref|+1e-3)="
          f"{worst:.3f}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: |Δ| exceeds 2^-7·|ref| + 1e-3 "
                             f"(worst ratio {worst})")
    return err


def _rect_plan(n_rows, n_cols, e, bs, seed):
    from repro_torch.graph.format import rect_block_sparse
    rng = np.random.default_rng(seed)
    return rect_block_sparse(rng.integers(0, n_rows, e).astype(np.int32),
                             rng.integers(0, n_cols, e).astype(np.int32),
                             rng.random(e).astype(np.float32),
                             n_rows, n_cols, bs)


def _skewed_plan(seed=11):
    """3 000 × 20 000 at bs=128: destination row 11 has 5 000 sources (it
    spans 79 kernel segments), rows 1 000–1 499 are empty, the other rows
    get ≈ 6 random sources each, so many rows straddle two segments."""
    from repro_torch.graph.format import rect_block_sparse
    rng = np.random.default_rng(seed)
    hub = rng.choice(20000, 5000, replace=False).astype(np.int32)
    dst = rng.integers(0, 3000, 20000).astype(np.int32)
    dst = dst[(dst < 1000) | (dst >= 1500)]
    src = rng.integers(0, 20000, dst.size).astype(np.int32)
    w = rng.random(5000 + dst.size).astype(np.float32)
    w[:5000] *= 0.015      # GCN-sized weights on the hub
    return rect_block_sparse(np.concatenate([np.full(5000, 11, np.int32), dst]),
                             np.concatenate([hub, src]), w, 3000, 20000, 128)


def _tiles(plan, t, dev, c=None):
    """A host plan's forward (t="") or transposed (t="_t") tiles on the
    card, instance c of a stack."""
    out = []
    for f in ("blocks", "block_rows", "block_cols"):
        a = getattr(plan, f + t)
        out.append(torch.from_numpy(np.ascontiguousarray(
            a if c is None else a[c])).to(dev))
    return out


def _arrays(plan_dev, t):
    return [getattr(plan_dev, f + t) for f in ("row_ptr", "col_idx", "vals")]


def _plain_spmm():
    """The SpMM entry points with the plain version in place of the kernel
    (on the card's tensors: no launch)."""
    from repro_torch.kernels.spmm import ops, spmm_csr_ref
    return mock.patch.object(ops, "spmm_csr", spmm_csr_ref)


def kernel_cases(dev) -> dict:
    """Phase 3; returns the largest max|Δ| over the cases with an fp32 h
    and over those with a bf16 h."""
    from repro_torch.graph.format import stack_plans
    from repro_torch.kernels.spmm import (aggregate_plan,
                                          block_sparse_plan_dev, spmm_csr,
                                          spmm_csr_ref, spmm_ref)
    errs = []
    gen = torch.Generator(device=dev).manual_seed(0)

    def both_ways(name, host, c=None, ds=(8, 41, 128, 200), repeat=False):
        plan = block_sparse_plan_dev(host, dev)
        plan = plan if c is None else plan.instance(c)
        for t, n_in, n_out in (("", plan.cols_padded, plan.rows_padded),
                               ("_t", plan.rows_padded, plan.cols_padded)):
            for d in ds:
                h = torch.randn(n_in, d, generator=gen, device=dev)
                got = spmm_csr(*_arrays(plan, t), h)
                errs.append(_held(
                    f"{name} d={d} {'transposed' if t else 'forward'}", got,
                    spmm_ref(*_tiles(host, t, dev, c), h, n_out=n_out)))
                if repeat and not torch.equal(got,
                                              spmm_csr(*_arrays(plan, t), h)):
                    raise AssertionError(f"{name} d={d}: a second launch "
                                         f"differs bitwise")
        return plan

    for bs in (32, 64, 128):
        both_ways(f"bs={bs} rect {3 * bs + 5}x{7 * bs + 3}",
                  _rect_plan(3 * bs + 5, 7 * bs + 3, 40 * bs, bs, seed=bs))
    skew = both_ways("skewed 3000x20000 (hub 5000, empty band)",
                     _skewed_plan(), ds=(41, 200), repeat=True)
    nnz = int(skew.row_ptr[-1])
    rows = skew.row_ptr.diff()
    print(f"  {'skewed case':<44} nnz {nnz}, longest row {int(rows.max())}"
          f", {int((rows == 0).sum())} empty rows; repeat launches "
          f"bitwise equal  ok")
    # the bf16 launch on the skewed plan: bf16 loads, fp32 sums (the
    # straddling rows' carried parts too), one rounding; its own generator,
    # so the fp32 cases' inputs are the ones they always were
    gen16 = torch.Generator(device=dev).manual_seed(16)
    bf16_errs = []
    for d in (41, 200):
        h = torch.randn(skew.cols_padded, d, generator=gen16,
                        device=dev).to(torch.bfloat16)
        got = spmm_csr(*_arrays(skew, ""), h)
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"skewed bf16 d={d}: output {got.dtype}")
        bf16_errs.append(_held_bf16(f"skewed bf16 h d={d} forward", got,
                               spmm_csr_ref(*_arrays(skew, ""), h)))
        if not torch.equal(got, spmm_csr(*_arrays(skew, ""), h)):
            raise AssertionError(f"skewed bf16 d={d}: a second launch "
                                 f"differs bitwise")
    print(f"  {'skewed case, bf16 h':<44} repeat launches bitwise equal  ok")

    # the naive path's layer-0 width (602 input features: four full
    # 128-column y-tiles and a partial fifth), and the DP path's shape
    # (local rows × local rows + one halo row, neither a multiple of bs)
    both_ways("bs=128 rect 1000x4000, naive layer-0 width",
              _rect_plan(1000, 4000, 30000, 128, seed=13), ds=(602,))
    both_ways("bs=128 DP-shaped 2300x2301 (local + halo row)",
              _rect_plan(2300, 2301, 40000, 128, seed=17), ds=(128, 602))

    sparse = _rect_plan(100, 300, 30, 64, seed=1)
    dense = _rect_plan(100, 300, 5000, 64, seed=2)
    stacked = stack_plans([sparse, dense])
    if sparse.nnzb >= dense.nnzb or stacked.blocks[0, -1].any():
        raise AssertionError("stacked case has no padding tiles")
    both_ways("bs=64 stack_plans instance with padding", stacked, c=0,
              ds=(41,))

    before = spmm_csr.launches
    empty = block_sparse_plan_dev(_rect_plan(90, 60, 0, 32, seed=3), dev)
    out = spmm_csr(*_arrays(empty, ""), torch.randn(64, 41, device=dev))
    if out.shape != (96, 41) or out.any() or spmm_csr.launches != before:
        raise AssertionError("empty plan must launch nothing, give zeros")
    print(f"  {'empty plan (no nonzero)':<44} zeros, no launch  ok")

    for bs, d in ((64, 41), (128, 200)):
        plan = block_sparse_plan_dev(
            _rect_plan(2 * bs + 7, 5 * bs + 1, 30 * bs, bs, seed=7 + bs),
            dev)
        h = torch.randn(plan.n_cols, d, generator=gen, device=dev,
                        requires_grad=True)
        cot = torch.randn(plan.rows_padded, d, generator=gen, device=dev)
        got = aggregate_plan(plan, h)
        (got_g,) = torch.autograd.grad(got, h, cot)
        with _plain_spmm():
            want = aggregate_plan(plan, h)
            (want_g,) = torch.autograd.grad(want, h, cot)
        errs.append(_held(f"bs={bs} d={d} aggregate_plan forward",
                          got.detach(), want.detach()))
        errs.append(_held(f"bs={bs} d={d} aggregate_plan backward",
                          got_g, want_g))
    return {"float32": max(errs), "bfloat16": max(bf16_errs)}


def _random_bsg(n, bs, deg, seed):
    """A random GCN-normalized graph with self-loops and its tiles."""
    from repro_torch.graph.format import block_sparse, build_graph
    rng = np.random.default_rng(seed)
    g = build_graph(rng.integers(0, n, n * deg).astype(np.int32),
                    rng.integers(0, n, n * deg).astype(np.int32), n)
    return g, block_sparse(g, bs=bs)


def oneshot_cases(dev) -> dict:
    """Phase 3's one-shot cases: ``aggregate_pallas`` on ``block_sparse_dev``
    (one launch a call) and on ``square_plan_dev`` (two a forward and
    backward) against the plain version on the same arrays; returns the
    largest max|Δ| with an fp32 h and with a bf16 h."""
    from repro_torch.kernels.spmm import (aggregate_pallas, block_sparse_dev,
                                          spmm_csr, spmm_dense_ref,
                                          square_plan_dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    errs, bf16_errs = [], []

    def launched(name, fn, want: int):
        before = spmm_csr.launches
        out = fn()
        if spmm_csr.launches - before != want:
            raise AssertionError(f"{name}: {spmm_csr.launches - before} "
                                 f"spmm_csr launches, expected {want}")
        return out

    for bs in (32, 64, 128):
        n = 7 * bs + 5
        g, bsg = _random_bsg(n, bs, 6, seed=bs)
        dense = torch.from_numpy(g.dense_adjacency()).to(dev)
        for tiles in (torch.float32, torch.bfloat16):
            a = block_sparse_dev(bsg, tiles, dev)
            for d in (8, 41, 128):
                h = torch.randn(n, d, generator=gen, device=dev)
                name = (f"one-shot bs={bs} n={n} d={d} "
                        f"{str(tiles)[6:]} tiles")
                got = launched(name, lambda: aggregate_pallas(a, h), 1)
                with _plain_spmm():
                    errs.append(_held(name, got, aggregate_pallas(a, h)))
                if tiles == torch.float32:
                    errs.append(_held("  vs the dense oracle", got,
                                      spmm_dense_ref(dense, h)))

    g, bsg = _random_bsg(3000, 128, 16, seed=5)
    a = block_sparse_dev(bsg, device=dev)
    for d in (41, 128, 602):
        h = torch.randn(3000, d, generator=gen, device=dev).to(torch.bfloat16)
        name = f"one-shot bs=128 n=3000 bf16 h d={d}"
        got = launched(name, lambda: aggregate_pallas(a, h), 1)
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"{name}: output {got.dtype}")
        with _plain_spmm():
            bf16_errs.append(_held_bf16(name, got, aggregate_pallas(a, h)))

    plan = square_plan_dev(bsg, device=dev)
    for d in (41, 128):
        h = torch.randn(3000, d, generator=gen, device=dev,
                        requires_grad=True)
        cot = torch.randn(3000, d, generator=gen, device=dev)

        def fwd_bwd():
            y = aggregate_pallas(plan, h)
            return y, torch.autograd.grad(y, h, cot)[0]

        got, got_g = launched(f"square plan d={d}", fwd_bwd, 2)
        with _plain_spmm():
            want, want_g = fwd_bwd()
        errs.append(_held(f"square_plan_dev bs=128 n=3000 d={d} forward",
                          got.detach(), want.detach()))
        errs.append(_held(f"  backward", got_g, want_g))
    h = torch.randn(3000, 41, generator=gen, device=dev, requires_grad=True)
    try:
        launched("a refused gradient", lambda: aggregate_pallas(a, h), 0)
    except RuntimeError as e:
        if "square_plan_dev" not in str(e):
            raise
        print(f"  {'BlockSparseDev under grad':<44} refused, no launch  ok")
    else:
        raise AssertionError("aggregate_pallas on a BlockSparseDev ran "
                             "under grad with an h that requires grad")
    return {"float32": max(errs), "bfloat16": max(bf16_errs)}


def oneshot(dev) -> dict:
    """Phase 3's one-shot path at the reference kernel bench's micro shape
    (``sbm_power_law(n=4096, num_classes=8, feat_dim=128, avg_degree=16,
    seed=7)``, bs 128, d 128): ``block_sparse_dev``'s derivation timed
    once; with the counts zeroed just before and read just after, for fp32
    and for bf16 h, ``aggregate_pallas`` on the ``BlockSparseDev`` and a
    forward and backward through ``square_plan_dev`` (3 launches a dtype),
    held against the plain version, the one-shot product bitwise the
    plan's forward; then each dtype's call timed (device time, min of two
    runs of 20) beside its CUDA-event time, the plain version,
    ``torch.sparse.mm`` on torch's CSR of the tiles (bf16 values for the
    bf16 h, held to 1e-2·(1 + max|ref|)) and its bound."""
    from repro_torch.graph import block_sparse, sbm_power_law
    from repro_torch.kernels.spmm import (aggregate_pallas, block_sparse_dev,
                                          spmm_csr, square_plan_dev)
    from repro_torch.kernels.spmm.spmm import reset_launches
    g = sbm_power_law(n=4096, num_classes=8, feat_dim=128, avg_degree=16,
                      seed=7).graph
    bsg = block_sparse(g, bs=128)
    torch.cuda.synchronize()
    t = time.perf_counter()
    a = block_sparse_dev(bsg, device=dev)
    torch.cuda.synchronize()
    derive_ms = (time.perf_counter() - t) * 1e3
    plan = square_plan_dev(bsg, device=dev)
    nnz = int(a.row_ptr[-1])
    rng = np.random.default_rng(0)
    hs = {dt: torch.from_numpy(rng.normal(size=(g.n, 128)).astype(
        np.float32)).to(dev).to(dt) for dt in (torch.float32, torch.bfloat16)}
    gen = torch.Generator(device=dev).manual_seed(5)
    cots = {dt: torch.randn(g.n, 128, generator=gen, device=dev).to(dt)
            for dt in hs}

    def path(h, cot):
        hg = h.detach().requires_grad_()
        yp = aggregate_pallas(plan, hg)
        return aggregate_pallas(a, h), yp.detach(), \
            torch.autograd.grad(yp, hg, cot)[0]

    reset_launches()
    outs = {dt: path(hs[dt], cots[dt]) for dt in hs}
    torch.cuda.synchronize()
    launches = dict(spmm_csr.launches_by_dtype)
    print(f"  one-shot path (sbm_power_law n=4096, bs 128, d 128, {nnz} "
          f"nonzeros): block_sparse_dev derived in {derive_ms:.2f} ms; "
          f"spmm_csr launches by dtype {launches}")
    if launches != {"float32": 3, "bfloat16": 3}:
        raise AssertionError(f"one-shot path: launches {launches}, expected "
                             f"3 a dtype (one one-shot, a plan's forward "
                             f"and backward)")
    tiles = [torch.from_numpy(getattr(bsg, f)).to(dev)
             for f in ("blocks", "block_rows", "block_cols")]
    rows = {}
    for dt, h in hs.items():
        key = str(dt)[6:]
        with _plain_spmm():
            want = path(h, cots[dt])
        held = _held if dt == torch.float32 else _held_bf16
        err = max(held(f"one-shot {key} h {what}", got, ref)
                  for what, got, ref in zip(
                      ("aggregate_pallas", "square plan forward",
                       "square plan backward"), outs[dt], want))
        if not torch.equal(outs[dt][0], outs[dt][1]):
            raise AssertionError(f"one-shot {key}: the BlockSparseDev's "
                                 f"product differs from the plan's forward")

        def kern():
            return aggregate_pallas(a, h)

        def plain():
            with _plain_spmm():
                return aggregate_pallas(a, h)

        a_csr = _csr_of_tiles(tiles[0].to(dt), *tiles[1:], g.n, g.n)

        def lib():
            return torch.sparse.mm(a_csr, h)

        lib_err = _held(f"  torch.sparse.mm ({key} CSR) vs kernel",
                        lib().float(), outs[dt][0].float(),
                        KERNEL_TOL if dt == torch.float32 else SDPA_TOL)
        k_runs = [_device_ms(kern, 20), _device_ms(kern, 20)]
        k_ms = [t for t, _ in k_runs]
        l_ms = [_device_ms(lib, 20)[0], _device_ms(lib, 20)[0]]
        ev_ms = _time_ms(kern, 20)
        p_ms = _time_ms(plain, 5)
        bound_ms, by, nbytes, flops = _spmm_bound(
            nnz, g.n, g.n, 128, itemsize=h.element_size())
        rows[key] = dict(
            ms=min(k_ms), ms_runs=k_ms,
            memset_ms=min(m for _, m in k_runs), event_ms=ev_ms,
            plain_ms=p_ms, library_ms=min(l_ms), library_ms_runs=l_ms,
            library_err=lib_err, bound_ms=bound_ms, bound_by=by, nnz=nnz,
            bytes=nbytes, flops=flops, max_abs_err=err,
            launches=launches[key])
        print(f"  one-shot {key} h: kernel {k_ms[0]:.4f} / {k_ms[1]:.4f} ms "
              f"device time (memset {rows[key]['memset_ms']:.4f}; "
              f"{ev_ms:.4f} ms a call by CUDA events), plain {p_ms:.4f} ms,"
              f" torch.sparse.mm {l_ms[0]:.4f} / {l_ms[1]:.4f} ms; bound "
              f"{bound_ms:.4f} ms by {by} ({nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.4f} GFLOP)")
    return {"derive_ms": derive_ms, "launches": launches, **rows}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _drive(name, step, evaluate, params0, opt, per_step: int, why: str,
           timed: int = 10):
    """3 warm-up + ``timed`` steps of ``step`` from ``params0``: finite and
    falling loss, ``per_step`` SpMM launches on every step (``why`` says
    whence); then the val accuracy, where there is an ``evaluate``.  The launch count is zeroed just before the steps and read
    just after.  Returns (params, opt state, losses, launches, median
    step ms)."""
    from repro_torch.kernels.spmm import spmm_csr
    params, state = params0, opt.init(params0)
    losses, ms = [], []
    spmm_csr.launches = 0
    steps = 3 + timed
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, loss = step(params, state)
        losses.append(loss.item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        print(f"  step {i:2d} {'warm-up' if i < 3 else 'timed  '} "
              f"loss {losses[-1]:.6f}  {ms[-1]:.2f} ms")
    launches = spmm_csr.launches
    median_ms = statistics.median(ms[3:])
    print(f"  {name}: median step {median_ms:.2f} ms over {timed} timed "
          f"steps; spmm_csr launches {launches} ({launches / steps:.0f} per "
          f"step)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss did not fall: {losses[0]} → "
                             f"{losses[-1]}")
    if launches != steps * per_step:
        raise AssertionError(f"{name}: expected {per_step} kernel launches "
                             f"per step ({why}), got {launches} in {steps} "
                             f"steps")
    if evaluate is not None:
        _, val_acc = evaluate(params, "val")
        print(f"  val accuracy after {steps} steps {val_acc.item():.4f}")
    return params, state, losses, launches, median_ms


def _param_bytes(params) -> float:
    from repro_torch.params import tree_leaves
    return float(sum(p.numel() * p.element_size()
                     for p in tree_leaves(params)))


def _hold_ledger(name, step, params, state, a2a_calls: int,
                 a2a_mirrored: int, a2a_payload: float,
                 param_bytes: float, all_gather=None) -> dict:
    """Collect the ledger of one more step and hold it to the schedule's
    contract at N=1: the all-to-alls' forward and backward calls and
    their payload from the shapes, one stacked loss psum of 12 bytes, one
    gradient all-reduce of the parameters' bytes, and no wire bytes (the
    ring factor is 0 at N=1).  ``all_gather=(calls, payload)``: GAT's
    score all-gathers, each with its backward.  The same step is audited
    (:func:`_audited_step`); its backward's collectives must have run on
    autograd's own thread, not the caller's."""
    ledger, census = _audited_step(name, step, params, state)
    if a2a_mirrored and set(census.threads.get("backward", ())) & set(
            census.threads.get("forward", ())):
        raise AssertionError(
            f"{name}: backward collectives on the caller's thread "
            f"{census.threads}: autograd runs a CUDA backward on its own")

    def entry(calls, payload, mirrored=0):
        return {"calls": float(calls), "payload_bytes": float(payload),
                "wire_bytes": 0.0, "mirrored_calls": float(mirrored),
                "mirrored_wire_bytes": 0.0}

    want = {"all_to_all|model|float32": entry(a2a_calls, a2a_payload,
                                              a2a_mirrored),
            "grad_psum|model|float32": entry(1, param_bytes),
            "psum|model|float32": entry(1, 12)}
    if all_gather is not None:
        calls, payload = all_gather
        want["all_gather|model|float32"] = entry(calls, payload, calls)
    got = ledger.as_dict()
    print(f"  ledger of one {name} step: {json.dumps(got)}")
    if got != want:
        raise AssertionError(f"{name}: ledger {got} is not the schedule's "
                             f"{want}")
    gathers = "" if all_gather is None else (
        f"; {all_gather[0]} all-gathers forward + {all_gather[0]} "
        f"backward, {all_gather[1]:.0f} payload bytes")
    print(f"  {name} ledger: {a2a_calls} all-to-alls forward + "
          f"{a2a_mirrored} backward = {a2a_calls + a2a_mirrored} per step, "
          f"{a2a_payload:.0f} payload bytes{gathers}, 0 wire bytes at N=1  "
          f"ok")
    return got


def _audited_step(name, step, *args, by_pass: bool = True):
    """One call of ``step`` with its collective ledger and the census of
    the collectives it issued (``torch.profiler``, below the choke point,
    forward and backward on every thread): the audit must be clean.
    Returns (ledger, census)."""
    from repro_torch.analysis import audit as A
    from repro_torch.runtime.telemetry import collect_comm
    with collect_comm() as ledger:
        _, census = A.census(step, *args)
    A.assert_clean(census, ledger, tag=name, by_pass=by_pass)
    print(f"  {name} audit clean: census {json.dumps(census.as_dict())}; "
          f"threads {census.threads}")
    return ledger, census


def _hold_same(name, got, others, first_loss: float) -> None:
    """Hold the step-0 ``got = (loss, grads)`` to the first step's loss
    and to each ``(label, (loss, grads))`` of ``others``, per tensor
    within ``PATH_RTOL``."""
    from repro_torch.params import tree_leaves
    loss, grads = got
    if abs(loss.item() - first_loss) > PATH_RTOL * abs(first_loss):
        raise AssertionError(f"{name}: step-0 loss differs from the first "
                             f"step's")
    for label, (lo, go) in others:
        _held(f"{name} step-0 loss, {label}", loss, lo, PATH_RTOL, 0.0)
        for i, (a, b) in enumerate(zip(tree_leaves(grads),
                                       tree_leaves(go))):
            _held(f"{name} step-0 grad {i} {tuple(a.shape)}, {label}", a, b,
                  PATH_RTOL, 0.0)


def _hold_step0(name, vg, vg_segment, params0, mask, first_loss) -> None:
    """The step-0 loss and grads of the kernel path against the same path
    with the plain version patched in on the card, and against the
    segment backend, each within ``PATH_RTOL``."""
    got = vg(params0, mask)
    with _plain_spmm():
        plain = vg(params0, mask)
    _hold_same(name, got, [("kernel vs plain", plain),
                           ("kernel vs segment", vg_segment(params0, mask))],
               first_loss)


def _path_info(launches, median_ms, profile, ledger, losses) -> dict:
    return {"launches": launches, "step_ms": median_ms, "profile": profile,
            "ledger": ledger, "loss_first": losses[0],
            "loss_last": losses[-1]}


def train(dev):
    """Phase 6; returns (bundle, data, cfg, path info)."""
    from repro_torch import optim
    from repro_torch.core import decouple as D
    from repro_torch.gnn import models as M
    from repro_torch.graph.synthetic import reddit_like
    from repro_torch.runtime import TPMesh

    t0 = time.perf_counter()
    data = reddit_like(scale=1.0, seed=0)
    bundle = D.prepare_bundle(data, n_workers=1, n_chunks=4,
                              agg="blocksparse", agg_block_size=128,
                              device=dev)
    torch.cuda.synchronize()
    plan = bundle.graph.bsp
    nnz = plan.row_ptr[:, -1].tolist()
    print(f"  graph n={data.graph.n} E={data.graph.e} "
          f"features={data.features.shape[1]} classes={data.num_classes}; "
          f"plans of bs={plan.bs} tiles, compressed to {nnz} nonzeros per "
          f"chunk ({plan.rows_padded} rows over {plan.cols_padded} sources); "
          f"prepared in {time.perf_counter() - t0:.1f} s")

    mesh = TPMesh()
    cfg = D.padded_gnn_config(data, bundle, hidden_dim=128, num_layers=2)
    params0 = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = optim.adamw(1e-2, weight_decay=5e-4)
    step, evaluate = D.make_tp_train_fns(cfg, bundle, mesh, opt,
                                         mode="decoupled_pipelined")
    params, state, losses, launches, median_ms = _drive(
        "decoupled_pipelined", step, evaluate, params0, opt, 16,
        "2 rounds × 4 chunks × forward and backward")
    profile = _profile(lambda: step(params, state), "step")
    # per chunk one split send (N, m_split, D/N) and one gather send
    # (N, m_gather, D/N) of the D padded classes, each with its backward
    cp, chunks = bundle.graph.comm_plan, bundle.graph.chunked.n_chunks
    ledger = _hold_ledger(
        "decoupled_pipelined", step, params, state, 2 * chunks, 2 * chunks,
        4 * cfg.num_classes * chunks * (cp.m_split + cp.m_gather),
        _param_bytes(params0))
    _hold_step0("decoupled_pipelined",
                D.make_tp_value_and_grad(cfg, bundle, mesh,
                                         mode="decoupled_pipelined"),
                D.make_tp_value_and_grad(cfg, bundle, mesh,
                                         mode="decoupled_pipelined",
                                         agg="segment"),
                params0, bundle.train_mask, losses[0])
    return bundle, data, cfg, _path_info(launches, median_ms, profile,
                                         ledger, losses)


def _widths(cfg) -> list:
    """The width each coupled layer aggregates: the input features, then
    the hidden width."""
    return [cfg.in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)


def naive(bundle, data, cfg, dev) -> dict:
    """Phase 7: naive TP on phase 6's bundle and config."""
    from repro_torch import optim
    from repro_torch.core import decouple as D
    from repro_torch.gnn import models as M
    from repro_torch.runtime import TPMesh

    mesh = TPMesh()
    params0 = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = optim.adamw(1e-2, weight_decay=5e-4)
    step, evaluate = D.make_tp_train_fns(cfg, bundle, mesh, opt,
                                         mode="naive", agg="blocksparse")
    params, state, losses, launches, median_ms = _drive(
        "naive", step, evaluate, params0, opt, 12,
        "layer 0 forward only, 4 chunks: its input features carry no "
        "gradient; layer 1 forward and backward, 4 + 4")
    profile = _profile(lambda: step(params, state), "naive step")
    # per layer a split send (V/N, D) and a gather send (V, D/N) of the
    # layer's width; layer 0's have no backward (4L − 2 in all)
    n, layers = bundle.n_padded, cfg.num_layers
    ledger = _hold_ledger("naive", step, params, state, 2 * layers,
                          2 * layers - 2, 2 * 4 * n * sum(_widths(cfg)),
                          _param_bytes(params0))
    _hold_step0("naive",
                D.make_tp_value_and_grad(cfg, bundle, mesh, mode="naive"),
                D.make_tp_value_and_grad(cfg, bundle, mesh, mode="naive",
                                         agg="segment"),
                params0, bundle.train_mask, losses[0])
    return _path_info(launches, median_ms, profile, ledger, losses)


def dp(data, dev) -> tuple[dict, float]:
    """Phase 8: the DP halo-exchange baseline at k=1 on the same graph;
    returns (path info, max|Δ| of the kernel on its plan)."""
    from repro_torch import optim
    from repro_torch.gnn import dp_baseline as DP
    from repro_torch.gnn import models as M
    from repro_torch.kernels.spmm import spmm_csr, spmm_csr_ref
    from repro_torch.runtime import TPMesh

    t0 = time.perf_counter()
    bundle = DP.prepare_dp_bundle(data, k=1, agg="blocksparse",
                                  agg_block_size=128, device=dev)
    torch.cuda.synchronize()
    g, plan = bundle.graph, bundle.graph.bsp.instance(0)
    print(f"  k={g.k}: {g.n_local_max} local rows, halo {g.halo_size} "
          f"(m={g.m}); rectangular plan {plan.n_rows}x{plan.n_cols} "
          f"({plan.rows_padded}x{plan.cols_padded} padded), "
          f"{int(plan.row_ptr[-1])} nonzeros; prepared in "
          f"{time.perf_counter() - t0:.1f} s")
    mesh = TPMesh()
    cfg = M.GNNConfig(in_dim=data.features.shape[1], hidden_dim=128,
                      num_classes=data.num_classes, num_layers=2)
    params0 = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = optim.adamw(1e-2, weight_decay=5e-4)
    step, evaluate = DP.make_dp_train_fns(cfg, bundle, mesh, opt)
    params, state, losses, launches, median_ms = _drive(
        "dp", step, evaluate, params0, opt, 3,
        "one per layer forward, and layer 1's backward: layer 0's input "
        "features carry no gradient")
    profile = _profile(lambda: step(params, state), "dp step")
    # per layer one halo send (k, m, D) of the layer's width; layer 0's
    # has no backward (L + (L − 1) in all)
    layers = cfg.num_layers
    ledger = _hold_ledger("dp", step, params, state, layers, layers - 1,
                          4 * g.k * g.m * sum(_widths(cfg)),
                          _param_bytes(params0))
    _hold_step0("dp", DP.make_dp_value_and_grad(cfg, bundle, mesh),
                DP.make_dp_value_and_grad(cfg, bundle, mesh, agg="segment"),
                params0, bundle.train_mask, losses[0])
    # the kernel on this plan at both layers' widths, both directions
    gen = torch.Generator(device=dev).manual_seed(3)
    errs = []
    for t, n_in in (("", plan.cols_padded), ("_t", plan.rows_padded)):
        for d in _widths(cfg):
            h = torch.randn(n_in, d, generator=gen, device=dev)
            arrays = _arrays(plan, t)
            errs.append(_held(
                f"dp plan d={d} {'transposed' if t else 'forward'} vs plain",
                spmm_csr(*arrays, h), spmm_csr_ref(*arrays, h)))
    return _path_info(launches, median_ms, profile, ledger, losses), \
        max(errs)


# ---------------------------------------------------------------------------
# GAT under TP (the generalized decoupling), SAGE and GIN
# ---------------------------------------------------------------------------

def _single_device_vg(fwd, cfg, bundle):
    """(params, mask) → (loss, grads) of ``fwd`` on the bundle's whole
    padded graph and features, on one device: no split, no gather, no
    chunks."""
    from repro_torch.gnn import models as M
    from repro_torch.params import tree_leaves, tree_map, tree_unflatten

    def vg(params, mask):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        logits = fwd(p, cfg, bundle.graph.edges, bundle.features)
        loss_sum, _, cnt = M.masked_loss_and_acc(
            logits, bundle.labels, mask, bundle.graph.num_classes)
        loss = loss_sum / torch.clamp(cnt, min=1.0)
        # the first layers' a_l and a_r score nothing in the decoupled
        # GAT: zeros, as the TP step gives them
        grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), tree_unflatten(params, list(grads))

    return vg


def gat(bundle, data, dev, mode: str) -> dict:
    """Phases 10–11: GAT in ``mode`` on phase 6's bundle (GAT aggregates
    by segment sums whatever the bundle's backend: no SpMM launch)."""
    from repro_torch import optim
    from repro_torch.core import decouple as D
    from repro_torch.gnn import models as M
    from repro_torch.runtime import TPMesh

    mesh = TPMesh()
    cfg = D.padded_gnn_config(data, bundle, model="gat", hidden_dim=128,
                              num_layers=2)
    params0 = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = optim.adamw(1e-2, weight_decay=5e-4)
    step, evaluate = D.make_tp_train_fns(cfg, bundle, mesh, opt, mode=mode)
    name = f"gat {mode}"
    params, state, losses, launches, median_ms = _drive(
        name, step, evaluate, params0, opt, 0,
        "GAT's edge weights are computed at run time: segment sums")
    profile = _profile(lambda: step(params, state), f"{name} step")
    n, layers = bundle.n_padded, cfg.num_layers
    vg = D.make_tp_value_and_grad(cfg, bundle, mesh, mode=mode)
    if mode == "naive":
        # per layer a split send (V/N, D) and a gather send (V, D/N) of
        # h @ w, the layer's output width, each with its backward; two
        # (V/N,) score all-gathers a layer
        widths = [cfg.hidden_dim] * (layers - 1) + [cfg.num_classes]
        ledger = _hold_ledger(name, step, params, state, 2 * layers,
                              2 * layers, 2 * 4 * n * sum(widths),
                              _param_bytes(params0),
                              all_gather=(2 * layers, 2 * layers * 4 * n))
        others = [("naive vs single-device coupled",
                   _single_device_vg(M.coupled_forward, cfg, bundle))]
    else:
        # phase 6's all-to-alls, and the two score all-gathers of the last
        # layer's (V/N,) scores
        cp, chunks = bundle.graph.comm_plan, bundle.graph.chunked.n_chunks
        ledger = _hold_ledger(
            name, step, params, state, 2 * chunks, 2 * chunks,
            4 * cfg.num_classes * chunks * (cp.m_split + cp.m_gather),
            _param_bytes(params0), all_gather=(2, 2 * 4 * n))
        others = [("pipelined vs decoupled",
                   D.make_tp_value_and_grad(cfg, bundle, mesh,
                                            mode="decoupled")),
                  ("pipelined vs single-device",
                   _single_device_vg(M.decoupled_forward, cfg, bundle))]
    mask = bundle.train_mask
    _hold_same(name, vg(params0, mask),
               [(label, fn(params0, mask)) for label, fn in others],
               losses[0])
    return _path_info(launches, median_ms, profile, ledger, losses)


def gcn_like(bundle, data, dev) -> dict:
    """Phase 12: SAGE and GIN decoupled-pipelined on phase 6's
    blocksparse bundle: γ·Â propagation, so the SpMM kernel runs."""
    from repro_torch import optim
    from repro_torch.core import decouple as D
    from repro_torch.gnn import models as M
    from repro_torch.runtime import TPMesh

    mesh, out = TPMesh(), {}
    for model in ("sage", "gin"):
        cfg = D.padded_gnn_config(data, bundle, model=model, hidden_dim=128,
                                  num_layers=2)
        params0 = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
        opt = optim.adamw(1e-2, weight_decay=5e-4)
        step, evaluate = D.make_tp_train_fns(cfg, bundle, mesh, opt,
                                             mode="decoupled_pipelined")
        params, state, losses, launches, median_ms = _drive(
            model, step, evaluate, params0, opt, 16,
            "2 rounds × 4 chunks × forward and backward")
        profile = _profile(lambda: step(params, state), f"{model} step")
        _hold_step0(model,
                    D.make_tp_value_and_grad(cfg, bundle, mesh,
                                             mode="decoupled_pipelined"),
                    D.make_tp_value_and_grad(cfg, bundle, mesh,
                                             mode="decoupled_pipelined",
                                             agg="segment"),
                    params0, bundle.train_mask, losses[0])
        out[model] = {"launches": launches, "step_ms": median_ms,
                      "profile": profile, "loss_first": losses[0],
                      "loss_last": losses[-1]}
    return out


# ---------------------------------------------------------------------------
# Hybrid DP×TP on a (data, model) mesh
# ---------------------------------------------------------------------------

HYBRID_RTOL = 1e-6


@contextlib.contextmanager
def _deterministic(label: str):
    """torch's deterministic algorithms: GAT's segment sums
    (``index_add_``) then accumulate in a fixed order, not by atomics, so
    two runs of a step agree bitwise.  An op with no deterministic kernel
    warns and runs as before; those warnings alone are taken, and the ops
    they name are printed, since a hold that flakes rests on them.  Every
    other warning is shown as usual."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    caught = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        fell_back = set()
        for w in caught:
            text = str(w.message)
            if "deterministic" in text.lower():
                fell_back.add("cuBLAS (CUBLAS_WORKSPACE_CONFIG unset)"
                              if "CuBLAS" in text
                              else text.split(" does not have")[0][:80])
            else:
                warnings.showwarning(w.message, w.category, w.filename,
                                     w.lineno)
        print(f"  {label}: ops run without a deterministic kernel: "
              f"{sorted(fell_back) or 'none'}")


def _hold_equal(name, got, want, what: str = "hybrid vs pure TP") -> float:
    """Hold the step-0 ``got = (loss, grads)`` to ``want`` per tensor,
    max|Δ| ≤ HYBRID_RTOL·max|ref|; returns the largest max|Δ|."""
    from repro_torch.params import tree_leaves
    pairs = [("loss", got[0], want[0])] + [
        (f"grad {i} {tuple(a.shape)}", a, b) for i, (a, b) in
        enumerate(zip(tree_leaves(got[1]), tree_leaves(want[1])))]
    worst = 0.0
    for label, a, b in pairs:
        worst = max(worst, _held(f"{name} step-0 {label}, {what}", a, b,
                                 HYBRID_RTOL, 0.0))
    return worst


def hybrid(bundle, data, dev, pure: dict, card: str) -> dict:
    """Phase 13: hybrid DP×TP on ``hybrid_mesh(model=1, data=1)``, NCCL
    subgroups of one rank: GCN decoupled-pipelined and naive on phase 6's
    bundle, the DP baseline, GAT decoupled-pipelined.  ``pure`` maps each
    path to its pure-TP info from phases 6, 7, 8 and 10 (their ledgers)."""
    from repro_torch import optim
    from repro_torch.core import decouple as D
    from repro_torch.gnn import dp_baseline as DP
    from repro_torch.gnn import models as M
    from repro_torch.runtime import TPMesh, hybrid_mesh

    mesh, pure_mesh = hybrid_mesh(model=1, data=1), TPMesh()
    print(f"  mesh {mesh.shape}: data axes {mesh.data_axes}, "
          f"{mesh.n_devices} rank; model and data groups of one rank")
    t0 = time.perf_counter()
    dp_bundle = DP.prepare_dp_bundle(data, mesh=mesh, agg="blocksparse",
                                     agg_block_size=128, device=dev)
    print(f"  DP bundle from the mesh (k=1, n_replicas=1): "
          f"{dp_bundle.graph.n_local_max} local rows; prepared in "
          f"{time.perf_counter() - t0:.1f} s")
    gcn_cfg = D.padded_gnn_config(data, bundle, hidden_dim=128, num_layers=2)
    gat_cfg = D.padded_gnn_config(data, bundle, model="gat", hidden_dim=128,
                                  num_layers=2)
    dp_cfg = M.GNNConfig(in_dim=data.features.shape[1], hidden_dim=128,
                         num_classes=data.num_classes, num_layers=2)
    v, c = bundle.n_padded, gcn_cfg.num_classes

    def tp(cfg, mode):
        def fns(m, opt=None):
            if opt is not None:
                return D.make_tp_train_fns(cfg, bundle, m, opt, mode=mode)
            return D.make_tp_value_and_grad(cfg, bundle, m, mode=mode)
        return fns

    def dp(m, opt=None):
        if opt is not None:
            return DP.make_dp_train_fns(dp_cfg, dp_bundle, m, opt)
        return DP.make_dp_value_and_grad(dp_cfg, dp_bundle, m)

    # path: (cfg, factory, train mask, SpMM launches a step, why, the
    # replica all-gathers: (calls, payload bytes, backward calls))
    paths = {
        "decoupled_pipelined": (
            gcn_cfg, tp(gcn_cfg, "decoupled_pipelined"), bundle.train_mask,
            16, "2 rounds × 4 chunks × forward and backward",
            (1, 4 * v * c, 1)),
        "naive": (
            gcn_cfg, tp(gcn_cfg, "naive"), bundle.train_mask, 12,
            "layer 0 forward only, layer 1 forward and backward",
            (2, 4 * v * sum(_widths(gcn_cfg)), 1)),
        "dp": (
            dp_cfg, dp, dp_bundle.train_mask, 3,
            "one per layer forward, and layer 1's backward",
            (2, 4 * dp_bundle.graph.n_local_max * sum(_widths(dp_cfg)), 1)),
        "gat_decoupled_pipelined": (
            gat_cfg, tp(gat_cfg, "decoupled_pipelined"), bundle.train_mask,
            0, "GAT's edge weights are computed at run time: segment sums",
            (1, 4 * v * c, 1)),
    }
    out = {}
    for name, (cfg, fns, mask, per_step, why, gathers) in paths.items():
        label = f"hybrid {name}"
        params0 = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
        opt = optim.adamw(1e-2, weight_decay=5e-4)
        step, evaluate = fns(mesh, opt)
        params, state, losses, launches, median_ms = _drive(
            label, step, evaluate, params0, opt, per_step, why, timed=5)
        profile = _profile(lambda: step(params, state), f"{label} step")
        print(f"  {label}: median step {median_ms:.2f} ms, device busy "
              f"{profile['busy_ms']:.2f} ms, idle share "
              f"{1 - profile['busy_ms'] / profile['wall_ms']:.3f}; {card}")
        # the pure-TP step's entries, its gradient all-reduce over model
        # and replicas, and the data-axis entries: the replica all-gathers
        # with their backward and the stacked loss psum, 0 wire bytes
        want = dict(pure[name]["ledger"])
        want["grad_psum|model+data|float32"] = want.pop(
            "grad_psum|model|float32")
        calls, payload, mirrored = gathers
        want["all_gather|data|float32"] = {
            "calls": float(calls), "payload_bytes": float(payload),
            "wire_bytes": 0.0, "mirrored_calls": float(mirrored),
            "mirrored_wire_bytes": 0.0}
        want["psum|data|float32"] = {
            "calls": 1.0, "payload_bytes": 12.0, "wire_bytes": 0.0,
            "mirrored_calls": 0.0, "mirrored_wire_bytes": 0.0}
        ledger, _ = _audited_step(label, step, params, state)
        got = ledger.as_dict()
        print(f"  ledger of one {label} step: {json.dumps(got)}")
        if got != want:
            raise AssertionError(f"{label}: ledger {got} is not the pure-TP "
                                 f"step's with the data-axis entries {want}")
        print(f"  {label} ledger: the pure-TP step's entries, grad_psum on "
              f"model+data, {calls} all-gathers on data ({payload} payload "
              f"bytes, {mirrored} backward), one loss psum on data  ok")
        # GAT's segment sums add by atomics: two runs of the same step
        # differ in the last bits unless the order is fixed
        with _deterministic(label):
            pure_step0 = fns(pure_mesh)(params0, mask)
            noise = _hold_equal(label, fns(pure_mesh)(params0, mask),
                                pure_step0, "pure TP run twice")
            diff = _hold_equal(label, fns(mesh)(params0, mask), pure_step0)
        print(f"  {label}: largest step-0 difference from pure TP {diff:.3e} "
              f"(pure TP against itself {noise:.3e}; deterministic "
              f"algorithms)")
        out[name] = _path_info(launches, median_ms, profile, got, losses)
        out[name]["max_diff_vs_pure"] = diff
    return out


# ---------------------------------------------------------------------------
# The constraint engine backend
# ---------------------------------------------------------------------------

def _moved(ledger: dict) -> dict:
    """The ledger's all-to-all, all-gather and h2d entries."""
    return {k: v for k, v in ledger.items()
            if k.split("|")[0] in ("all_to_all", "all_gather", "h2d")}


def constraint(bundle, data, dev, card: str) -> dict:
    """Phase 14: the constraint engine backend on six paths, each beside
    its explicit twin: GCN decoupled (and its alias), naive, DP, GAT
    decoupled, the streamed epoch and GCN decoupled on a hybrid mesh."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import optim
    from repro_torch.core import decouple as D
    from repro_torch.core import stream as ST
    from repro_torch.gnn import dp_baseline as DP
    from repro_torch.gnn import models as M
    from repro_torch.runtime import TPMesh, hybrid_mesh
    from repro_torch.runtime.telemetry import collect_comm

    mesh, hmesh = TPMesh(), hybrid_mesh(model=1, data=1)
    t0 = time.perf_counter()
    dp_bundle = DP.prepare_dp_bundle(data, k=1, agg="blocksparse",
                                     agg_block_size=128, device=dev)
    sb = ST.prepare_stream_bundle(data, 1, n_chunks=4, n_stripes=16,
                                  agg="blocksparse", agg_block_size=128,
                                  device=dev)
    torch.cuda.synchronize()
    print(f"  DP (k=1) and stream (4 chunks, 16 stripes) bundles prepared "
          f"in {time.perf_counter() - t0:.1f} s")
    gcn_cfg = D.padded_gnn_config(data, bundle, hidden_dim=128, num_layers=2)
    gat_cfg = D.padded_gnn_config(data, bundle, model="gat", hidden_dim=128,
                                  num_layers=2)
    dp_cfg = M.GNNConfig(in_dim=data.features.shape[1], hidden_dim=128,
                         num_classes=data.num_classes, num_layers=2)
    st_cfg = ST.stream_gnn_config(data, sb, hidden_dim=128, num_layers=2)

    def tp(cfg, mode, m):
        def fns(backend, opt=None):
            if opt is None:
                return D.make_tp_value_and_grad(cfg, bundle, m, mode=mode,
                                                backend=backend)
            return D.make_tp_train_fns(cfg, bundle, m, opt, mode=mode,
                                       backend=backend)
        return fns

    def dp(backend, opt=None):
        if opt is None:
            return DP.make_dp_value_and_grad(dp_cfg, dp_bundle, mesh,
                                             backend=backend)
        return DP.make_dp_train_fns(dp_cfg, dp_bundle, mesh, opt,
                                    backend=backend)

    def stream(backend, opt=None):
        vg = ST.make_stream_value_and_grad(st_cfg, sb, mesh, backend=backend)
        return vg if opt is None else (
            _stream_step_fn(vg, opt, sb.train_mask), None)

    # path: (cfg, factory, train mask, SpMM launches a step, why)
    paths = {
        "decoupled": (gcn_cfg, tp(gcn_cfg, "decoupled", mesh),
                      bundle.train_mask, 16,
                      "2 rounds × 4 chunks × forward and backward"),
        "naive": (gcn_cfg, tp(gcn_cfg, "naive", mesh), bundle.train_mask,
                  12, "layer 0 forward only, layer 1 forward and backward"),
        "dp": (dp_cfg, dp, dp_bundle.train_mask, 3,
               "one per layer forward, and layer 1's backward"),
        "gat_decoupled": (gat_cfg, tp(gat_cfg, "decoupled", mesh),
                          bundle.train_mask, 0,
                          "GAT's edge weights are computed at run time: "
                          "segment sums"),
        "stream": (st_cfg, stream, sb.train_mask, 16,
                   "2 rounds × 4 chunks on the half plans + 2 × 4 on the "
                   "transposed half plans"),
        "hybrid_decoupled": (gcn_cfg, tp(gcn_cfg, "decoupled", hmesh),
                             bundle.train_mask, 16,
                             "2 rounds × 4 chunks × forward and backward"),
    }
    out = {}
    for name, (cfg, fns, mask, per_step, why) in paths.items():
        label = f"constraint {name}"
        params0 = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
        runs = {}
        for backend in ("explicit", "constraint"):
            opt = optim.adamw(1e-2, weight_decay=5e-4)
            step, evaluate = fns(backend, opt)
            params, state, losses, launches, median_ms = _drive(
                f"{backend} {name}", step, evaluate, params0, opt, per_step,
                why, timed=5)
            profile = _profile(lambda: step(params, state),
                               f"{backend} {name} step")
            # the streamed epoch runs its split's transpose by hand
            ledger, census = _audited_step(
                f"{backend} {name}", step, params, state,
                by_pass=name != "stream")
            runs[backend] = _path_info(launches, median_ms, profile,
                                       ledger.as_dict(), losses)
            runs[backend]["audit_census"] = census.as_dict()
        got, want = runs["constraint"]["ledger"], runs["explicit"]["ledger"]
        print(f"  ledger of one {label} step: {json.dumps(got)}")
        if set(got) != set(_moved(got)) or _moved(got) != _moved(want):
            raise AssertionError(
                f"{label}: ledger {got} is not the explicit step's "
                f"all-to-all, all-gather and h2d entries {_moved(want)}")
        print(f"  {label} ledger: the explicit twin's all-to-all, all-gather "
              f"and h2d entries, no psum or grad_psum  ok")
        vg = fns("constraint")
        with CommDebugMode() as census:
            vg(params0, mask)
        torch.cuda.synchronize()
        counts = {str(k): v for k, v in census.get_comm_counts().items()}
        own = {k: v for k, v in counts.items()
               if k.startswith("c10d_functional.")}
        if set(own) - {"c10d_functional.all_reduce"}:
            raise AssertionError(f"{label}: DTensor ran collectives other "
                                 f"than all-reduces: {counts}")
        print(f"  {label}: CommDebugMode over one step {counts}; DTensor's "
              f"own {own or 'none (one rank)'}  ok")
        with _deterministic(label):
            twin = fns("explicit")(params0, mask)
            step0 = vg(params0, mask)
            diff = _hold_equal(label, step0, twin, "constraint vs explicit")
            if name == "decoupled":
                alias = tp(gcn_cfg, "decoupled_pipelined", mesh)("constraint")
                with collect_comm() as ledger:
                    got_alias = alias(params0, mask)
                _hold_equal(label, got_alias, step0,
                            "decoupled_pipelined (the alias) vs decoupled")
                with collect_comm() as led_d:
                    vg(params0, mask)
                calls = ledger.call_count("all_to_all", train=True)
                if ledger.as_dict() != led_d.as_dict() or calls != 4:
                    raise AssertionError(
                        f"{label}: the alias's ledger "
                        f"{ledger.as_dict()} is not decoupled's "
                        f"{led_d.as_dict()} (4 all-to-alls)")
                print(f"  {label}: decoupled_pipelined is its alias: the "
                      f"same step-0 and ledger, {calls:.0f} all-to-alls a "
                      f"step  ok")
        print(f"  {label}: largest step-0 difference from the explicit "
              f"twin {diff:.3e} (deterministic algorithms)")
        for backend, info in runs.items():
            p = info["profile"]
            print(f"  {label}: {backend:10s} median step "
                  f"{info['step_ms']:.2f} ms, device busy "
                  f"{p['busy_ms']:.2f} ms, idle share "
                  f"{1 - p['busy_ms'] / p['wall_ms']:.3f}; {card}")
        out[name] = {**runs["constraint"], "census": counts,
                     "max_diff_vs_explicit": diff,
                     "explicit": {k: runs["explicit"][k]
                                  for k in ("step_ms", "profile")}}
    return out


# ---------------------------------------------------------------------------
# The out-of-core streamed GCN step
# ---------------------------------------------------------------------------

STREAM_FOOTPRINT_V = (23040, 46080, 92160)
# At the step's peak (the gather's backward in the loss, N=1) five (V, C)
# f32 buffers are alive: z, the logits' cotangent, the all-to-all's send
# and receive buffers and its output.  The rest of the peak must not move
# with V by more than this.  The sweep's chunks hold 1 440 rows (16 at
# V = 23 040), so a chunk's edge messages (rows · 9 edges · C floats, two
# at once in the segment backend) stay below those five buffers and the
# peak is that one phase at every V.
STREAM_PEAK_BUFFERS = 5
STREAM_PEAK_TOL = 2 ** 18
SLEEP_CYCLES = 5_000_000      # ≈ 2.5 ms at the H100's clock


def _padded_data(data, n_padded: int):
    """``data`` with isolated vertices appended up to ``n_padded`` (no
    edge, zero features, label 0, in no mask): the vertex set the stream
    bundle pads to, so an in-memory bundle of it has the same chunks."""
    from repro_torch.core.decouple import _pad_graph
    from repro_torch.graph.format import pad_features
    from repro_torch.graph.synthetic import GraphData
    return GraphData(
        graph=_pad_graph(data.graph, n_padded),
        features=pad_features(data.features, n_padded),
        labels=pad_features(data.labels, n_padded),
        train_mask=pad_features(data.train_mask, n_padded),
        val_mask=pad_features(data.val_mask, n_padded),
        test_mask=pad_features(data.test_mask, n_padded),
        num_classes=data.num_classes)


def _stream_step_fn(vg, opt, mask):
    from repro_torch.optim import apply_updates

    def step(params, state):
        loss, grads = vg(params, mask)
        updates, state = opt.update(grads, state, params)
        return apply_updates(params, updates), state, loss
    return step


def _peak_bytes(fn) -> tuple[int, int]:
    """(allocated, reserved) device bytes that one call of ``fn`` adds at
    its peak over what was allocated (reserved) before it; the cached
    free blocks are released first, so the reserved figure counts what
    the call made the allocator hold."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - alloc0,
            torch.cuda.max_memory_reserved() - res0)


def _merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap_us(a, b, merged) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)


def _trace(fn, label: str) -> dict:
    """One call of ``fn`` under ``torch.profiler``, read from its trace:
    the host→device copies from pinned memory (count, summed device
    time), the share of that time during which a kernel runs on the
    compute stream (the stream of the SpMM launches), and the device's
    busy time (the union of every kernel, copy and memset) and idle
    share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    path = ROOT / "build" / f"trace_{label.replace(' ', '_')}.json"
    path.parent.mkdir(exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()

    def spans(pred):
        return [(e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream"))
                for e in events if e.get("ph") == "X" and pred(e)]

    def pinned_htod(e):
        return e.get("cat") == "gpu_memcpy" and \
            "Pinned -> Device" in e.get("name", "")

    copies = spans(pinned_htod)
    copy_bytes = sum(e.get("args", {}).get("bytes", 0) for e in events
                     if e.get("ph") == "X" and pinned_htod(e))
    pageable = spans(lambda e: e.get("cat") == "gpu_memcpy"
                     and "Pageable -> Device" in e.get("name", ""))
    kernels = spans(lambda e: e.get("cat") == "kernel")
    spmm = spans(lambda e: e.get("cat") == "kernel"
                 and "spmm_csr_kernel" in e.get("name", ""))
    device = spans(lambda e: e.get("cat") in ("kernel", "gpu_memcpy",
                                               "gpu_memset"))
    compute = {s for *_, s in spmm}
    merged = _merged([(a, b) for a, b, s in kernels if s in compute])
    copy_us = sum(b - a for a, b, _ in copies)
    overlap_us = sum(_overlap_us(a, b, merged) for a, b, _ in copies)
    busy_ms = sum(b - a for a, b in _merged(
        [(a, b) for a, b, _ in device])) / 1e3
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / wall_ms, "htod_copies": len(copies),
           "htod_ms": copy_us / 1e3, "htod_bytes": copy_bytes,
           "pageable_htod_copies": len(pageable),
           "overlap_share": overlap_us / copy_us if copy_us else 0.0,
           "spmm_launches": len(spmm),
           "spmm_ms": sum(b - a for a, b, _ in spmm) / 1e3,
           "compute_streams": sorted(str(s) for s in compute),
           "copy_streams": sorted({str(s) for *_, s in copies})}
    print(f"  traced {label}: {len(copies)} pinned host→device copies "
          f"({len(pageable)} pageable) of {copy_bytes} B on streams "
          f"{out['copy_streams']}, {copy_us / 1e3:.3f} ms device time, "
          f"{out['overlap_share']:.3f} "
          f"of it under a kernel on the compute stream "
          f"{out['compute_streams']}; {len(spmm)} SpMM launches "
          f"{out['spmm_ms']:.3f} ms; device busy {busy_ms:.3f} ms (union) "
          f"of {wall_ms:.2f} ms wall (idle share {out['idle_share']:.3f})")
    return out


def _link_ceiling(dev) -> float:
    """Bytes per second of a pinned 256 MB host→device copy (CUDA events,
    mean of 5 after a warm-up copy)."""
    src = torch.empty(256 * 2 ** 20, dtype=torch.uint8).pin_memory()
    dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
    ms = _time_ms(lambda: dst.copy_(src, non_blocking=True), 5)
    rate = src.numel() / (ms / 1e3)
    print(f"  pinned 256 MB host→device copy: {ms:.3f} ms, "
          f"{rate / 1e9:.2f} GB/s (the link's ceiling here)")
    return rate


def _staging_check(dev) -> None:
    """``stage`` and ``prefetched`` under a slow consumer and a slow
    producer: 8 distinct pinned buffers of 16 MB each, whose device
    checksums must equal their host sources'.  A slow consumer (a sleep
    on the compute stream before each read) shows a missing
    ``record_stream``: the copy stream would reuse a consumed buffer
    before the read; a slow producer (a sleep on the copy stream before
    each copy) shows a missing wait: the read would come before the
    copy."""
    from repro_torch.runtime import streaming as RS
    gen = torch.Generator().manual_seed(5)
    srcs = [torch.randint(0, 2 ** 24, (4 * 2 ** 20,), generator=gen,
                          dtype=torch.int32).pin_memory() for _ in range(8)]
    want = torch.stack([s.sum(dtype=torch.int64) for s in srcs])
    copy = torch.cuda.Stream(dev)
    for slow in ("consumer", "producer"):
        def stage(x):
            if slow == "producer":
                with torch.cuda.stream(copy):
                    torch.cuda._sleep(SLEEP_CYCLES)
            return RS.stage(x, dev, label="check", copy_stream=copy)

        sums = []
        for item in RS.prefetched(srcs, stage):
            x = item.take()
            if slow == "consumer":
                torch.cuda._sleep(SLEEP_CYCLES)
            sums.append(x.sum(dtype=torch.int64))
            del x
        got = torch.stack(sums).cpu()
        ok = torch.equal(got, want)
        print(f"  staging, slow {slow}: 8 pinned 16 MB buffers through "
              f"prefetched, checksums {'equal' if ok else 'DIFFER'}  "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"staging with a slow {slow}: checksums "
                                 f"{got.tolist()} != {want.tolist()}")


def _circulant(n: int, feat: int, classes: int, deg: int = 8, seed: int = 0):
    """Fixed in-degree graph: every vertex has ``deg`` distinct in-
    neighbours (v+1 … v+deg mod n) and its self loop, so every chunk holds
    exactly chunk_size·(deg+1) edges."""
    from repro_torch.graph.format import build_graph
    from repro_torch.graph.synthetic import GraphData
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(n, dtype=np.int32), deg)
    src = ((dst + np.tile(np.arange(1, deg + 1, dtype=np.int32), n))
           % n).astype(np.int32)
    labels = rng.integers(0, classes, n).astype(np.int32)
    feats = (np.eye(classes, feat, dtype=np.float32)[labels]
             + 0.5 * rng.standard_normal((n, feat), dtype=np.float32))
    mask = np.ones(n, bool)
    return GraphData(graph=build_graph(src, dst, n), features=feats,
                     labels=labels, train_mask=mask, val_mask=mask,
                     test_mask=mask, num_classes=classes)


def _footprint(dev, feat: int, classes: int) -> list:
    """The streamed step's device footprint as V grows 4× with the chunk
    and stripe counts in proportion (16 of each at the smallest V; segment
    backend, a circulant graph):
    ``device_resident_bytes``' staged figures must be equal at every V,
    and the measured peak minus its V-proportional buffers equal within
    ``STREAM_PEAK_TOL``."""
    from repro_torch.core import stream as ST
    from repro_torch.gnn import models as M
    from repro_torch.runtime import TPMesh
    rows = []
    for v in STREAM_FOOTPRINT_V:
        f = v // STREAM_FOOTPRINT_V[0]
        data = _circulant(v, feat, classes)
        sb = ST.prepare_stream_bundle(data, 1, n_chunks=16 * f,
                                      n_stripes=16 * f, agg="segment",
                                      device=dev)
        cfg = ST.stream_gnn_config(data, sb, hidden_dim=128, num_layers=2)
        params = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
        vg = ST.make_stream_value_and_grad(cfg, sb, TPMesh())
        loss, _ = vg(params, sb.train_mask)
        del loss
        peak, reserved = _peak_bytes(lambda: vg(params, sb.train_mask))
        foot = ST.device_resident_bytes(sb, cfg)
        v_bytes = STREAM_PEAK_BUFFERS * sb.n_padded * sb.c_padded * 4
        rows.append(dict(V=sb.n_padded, chunks=sb.n_chunks,
                         stripes=sb.n_stripes, store_bytes=sb.store.nbytes,
                         peak_bytes=peak, peak_reserved_bytes=reserved,
                         v_proportional_bytes=v_bytes,
                         residual_bytes=peak - v_bytes, **foot))
        print(f"  V={sb.n_padded}: {sb.n_chunks} chunks, {sb.n_stripes} "
              f"stripes, store {sb.store.nbytes / 1e6:.1f} MB; staged "
              f"{foot['staged_stripe_bytes']} + {foot['staged_chunk_bytes']}"
              f" B; peak {peak} B allocated, {reserved} B reserved; "
              f"{STREAM_PEAK_BUFFERS} (V, C) buffers {v_bytes} B; residual "
              f"{peak - v_bytes} B")
        del data, sb, vg, params
    for key in ("staged_stripe_bytes", "staged_chunk_bytes"):
        if len({r[key] for r in rows}) != 1:
            raise AssertionError(f"{key} differs across V: "
                                 f"{[r[key] for r in rows]}")
    res = [r["residual_bytes"] for r in rows]
    spread = max(res) - min(res)
    ok = spread <= STREAM_PEAK_TOL
    print(f"  staged bytes equal at V = {[r['V'] for r in rows]}; peak "
          f"residuals {res} B spread {spread} B (tolerance "
          f"{STREAM_PEAK_TOL} B)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"peak residual moves with V: {res}")
    return rows


def stream(data, dev) -> dict:
    """Phase 9: the out-of-core streamed GCN step (blocksparse half plans,
    16 stripes) beside the in-memory decoupled step on the same vertices;
    the staging primitives; the footprint as V grows."""
    from repro_torch import optim
    from repro_torch.core import decouple as D
    from repro_torch.core import stream as ST
    from repro_torch.gnn import models as M
    from repro_torch.params import tree_leaves
    from repro_torch.runtime import TPMesh
    from repro_torch.runtime.streaming import tree_tensors
    from repro_torch.runtime.telemetry import collect_comm

    t0 = time.perf_counter()
    sb = ST.prepare_stream_bundle(data, 1, n_chunks=4, n_stripes=16,
                                  agg="blocksparse", agg_block_size=128,
                                  device=dev)
    prep_s = time.perf_counter() - t0
    cfg = ST.stream_gnn_config(data, sb, hidden_dim=128, num_layers=2)
    h2d = ST.expected_h2d_bytes(sb, cfg)
    nnz = [int(f.row_ptr[-1]) for f, _ in sb.half_plans]
    plan_mb = sum(ST.chunk_input_nbytes(sb)) / 1e6
    print(f"  stream bundle: V={sb.n_padded} (lcm padding), {sb.n_chunks} "
          f"chunks, {sb.n_stripes} stripes; pinned store "
          f"{sb.store.nbytes / 1e6:.2f} MB, a stripe "
          f"{sb.store.stripe_nbytes / 1e6:.2f} MB "
          f"({sb.store.nbytes // sb.store.stripe_nbytes}×); half plans of "
          f"{nnz} nonzeros, {plan_mb:.2f} MB a direction, compressed on the "
          f"host one chunk's tiles at a time; prepared in {prep_s:.1f} s; "
          f"expected h2d {h2d / 1e6:.2f} MB a step")
    t0 = time.perf_counter()
    mem = D.prepare_bundle(_padded_data(data, sb.n_padded), n_workers=1,
                           n_chunks=4, agg="blocksparse",
                           agg_block_size=128, device=dev)
    torch.cuda.synchronize()
    for c, halves in enumerate(sb.half_plans):
        inst = mem.graph.bsp.instance(c)
        for hp, t in zip(halves, ("", "_t")):
            n = int(hp.row_ptr[-1])
            if not (torch.equal(hp.row_ptr, getattr(inst, "row_ptr" + t)
                                .cpu())
                    and torch.equal(hp.col_idx,
                                    getattr(inst, "col_idx" + t)[:n].cpu())
                    and torch.equal(hp.vals.view(torch.int32),
                                    getattr(inst, "vals" + t)[:n].cpu()
                                    .view(torch.int32))):
                raise AssertionError(f"chunk {c}{t}: the host half plan is "
                                     f"not the device-derived arrays")
    print(f"  in-memory twin on the same {sb.n_padded} vertices prepared in "
          f"{time.perf_counter() - t0:.1f} s; its compressed rows, derived "
          f"on the card, are bitwise the host half plans  ok")

    mesh = TPMesh()
    if D.padded_gnn_config(data, mem, hidden_dim=128, num_layers=2) != cfg:
        raise AssertionError("stream and in-memory configs differ")
    params0 = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = optim.adamw(1e-2, weight_decay=5e-4)
    vg = ST.make_stream_value_and_grad(cfg, sb, mesh)
    mem_vg = D.make_tp_value_and_grad(cfg, mem, mesh, mode="decoupled")
    mem_step, mem_eval = D.make_tp_train_fns(cfg, mem, mesh, opt,
                                             mode="decoupled")
    step = _stream_step_fn(vg, opt, sb.train_mask)
    params, state, losses, launches, median_ms = _drive(
        "stream", step, mem_eval, params0, opt, 16,
        "2 rounds × 4 chunks on the half plans + 2 × 4 on the transposed "
        "half plans")
    mem_params, mem_state, mem_losses, _, mem_ms = _drive(
        "in-memory decoupled", mem_step, mem_eval, params0, opt, 16,
        "2 rounds × 4 chunks forward and backward")

    ceiling = _link_ceiling(dev)
    trace = _trace(lambda: step(params, state), "stream step")
    mem_prof = _profile(lambda: mem_step(mem_params, mem_state),
                        "in-memory decoupled step")
    # the profiler can lose records: the rate is taken over the copies it
    # caught, by their own bytes
    link = trace["htod_bytes"] / (trace["htod_ms"] / 1e3) \
        if trace["htod_ms"] else 0.0
    bound_ms = max(h2d / ceiling * 1e3, mem_prof["busy_ms"])
    n_copies = 2 * sb.n_stripes + cfg.num_layers * len(
        tree_tensors(sb.half_plans))
    h2d_rate = h2d / (trace["htod_ms"] / 1e3) if trace["htod_ms"] else 0.0
    print(f"  h2d {h2d / 1e6:.3f} MB a step ({trace['htod_copies']} of "
          f"{n_copies} copies traced): {link / 1e9:.2f} GB/s, the traced "
          f"copies' bytes over their device time ({trace['htod_ms']:.3f} "
          f"ms; the step's h2d bytes over it: {h2d_rate / 1e9:.2f} GB/s), "
          f"{h2d / ceiling * 1e3:.3f} ms at the link's ceiling; overlap "
          f"share {trace['overlap_share']:.3f}; path bound max(h2d at "
          f"ceiling, in-memory busy {mem_prof['busy_ms']:.3f} ms) = "
          f"{bound_ms:.3f} ms; streamed step {median_ms:.2f} ms median, "
          f"in-memory {mem_ms:.2f} ms")

    with collect_comm() as led:
        vg(params0, sb.train_mask)
    with collect_comm() as mem_led:
        mem_vg(params0, mem.train_mask)
    got = led.as_dict()
    h2d_got = sum(v["payload_bytes"] for k, v in got.items()
                  if k.startswith("h2d|"))
    coll = {k: v for k, v in got.items() if not k.startswith("h2d|")}
    print(f"  ledger of one streamed step: {json.dumps(got)}")
    if h2d_got != h2d:
        raise AssertionError(f"h2d {h2d_got} B recorded, {h2d} B expected")
    if coll != mem_led.as_dict():
        raise AssertionError(f"collective entries {coll} differ from the "
                             f"in-memory step's {mem_led.as_dict()}")
    print(f"  h2d entries sum to expected_h2d_bytes ({h2d} B); collective "
          f"entries equal the in-memory decoupled step's  ok")

    _hold_step0("stream", vg, ST.make_stream_value_and_grad(
        cfg, sb, mesh, agg="segment"), params0, sb.train_mask, losses[0])
    loss_k, grads_k = vg(params0, sb.train_mask)
    loss_m, grads_m = mem_vg(params0, mem.train_mask)
    _held("stream step-0 loss vs in-memory decoupled", loss_k, loss_m,
          PATH_RTOL, 0.0)
    for i, (a, b) in enumerate(zip(tree_leaves(grads_k),
                                   tree_leaves(grads_m))):
        _held(f"stream step-0 grad {i} {tuple(a.shape)} vs in-memory", a, b,
              PATH_RTOL, 0.0)
    loss_2, grads_2 = vg(params0, sb.train_mask)
    if not (torch.equal(loss_k, loss_2) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(grads_k),
                                              tree_leaves(grads_2)))):
        raise AssertionError("two streamed steps from the same params "
                             "differ bitwise")
    print("  two streamed steps from the same params: loss and grads "
          "bitwise equal  ok")

    peak, peak_res = _peak_bytes(lambda: vg(params0, sb.train_mask))
    mem_peak, mem_res = _peak_bytes(lambda: mem_vg(params0, mem.train_mask))
    print(f"  peak device memory of a step (over what was allocated "
          f"before it): streamed {peak / 1e6:.2f} MB ({peak_res / 1e6:.2f} "
          f"MB reserved), in-memory {mem_peak / 1e6:.2f} MB "
          f"({mem_res / 1e6:.2f} MB reserved); the in-memory bundle holds "
          f"{_bundle_bytes(mem) / 1e6:.2f} MB on the card, the stream "
          f"bundle {_bundle_bytes(sb) / 1e6:.2f} MB")
    del mem, mem_vg, mem_step, mem_eval, mem_params, mem_state
    torch.cuda.empty_cache()

    _staging_check(dev)
    foot = _footprint(dev, data.features.shape[1], data.num_classes)
    info = _path_info(launches, median_ms, trace, got, losses)
    info.update(prepare_s=prep_s, in_memory_step_ms=mem_ms,
                htod_copies_expected=n_copies,
                in_memory_busy_ms=mem_prof["busy_ms"],
                in_memory_loss_last=mem_losses[-1], h2d_bytes=h2d,
                link_bytes_per_s=link, link_ceiling_bytes_per_s=ceiling,
                overlap_share=trace["overlap_share"], bound_ms=bound_ms,
                peak_bytes=peak, peak_reserved_bytes=peak_res,
                in_memory_peak_bytes=mem_peak,
                in_memory_peak_reserved_bytes=mem_res, footprint=foot)
    return info


def _bundle_bytes(bundle) -> int:
    """Bytes of the bundle's tensors that live on the card."""
    from repro_torch.runtime.streaming import tree_tensors
    seen, total = set(), 0
    for t in tree_tensors(bundle):
        if t.is_cuda and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
    return total


def _profile(fn, label: str) -> dict:
    """Device busy time and the top kernels of one call of ``fn`` under
    ``torch.profiler`` (diagnostic: the wall time includes the profiler's
    own cost)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    return _profile_summary(prof, wall_ms, label)


def _profile_summary(prof, wall_ms: float, label: str) -> dict:
    """Print and return the device busy time, idle share and top kernels
    of the finished profile ``prof`` over ``wall_ms``."""
    from torch.autograd import DeviceType
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    print(f"  profiled {label}: device busy {busy_ms:.2f} ms of "
          f"{wall_ms:.2f} ms wall (idle share {1 - busy_ms / wall_ms:.3f})")
    for name, ms, count in kernels[:8]:
        print(f"    {ms:9.3f} ms  {count:5d}×  {name[:70]}")
    port = [k for k in kernels if any(n in k[0] for n in PORT_KERNELS)]
    for name, ms, count in port:
        print(f"    port kernel: {ms:9.3f} ms  {count:5d}×  {name[:60]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "top": [[n[:70], ms, c] for n, ms, c in kernels[:8]],
            "port": [[n[:70], ms, c] for n, ms, c in port]}


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int) -> tuple[float, float]:
    """Device time of one call of ``fn`` and the memsets' part of it, from
    ``torch.profiler`` over ``iters`` calls after one warm-up call: for
    each kernel or memset, the mean time of its records times its records
    per call.  For launches of a few microseconds, where CUDA events over
    back-to-back calls time the host's Python and launch cost instead.

    The profiler can lose records (a profile of 10 SSD launches has held
    8): the sum of the records over ``iters`` would then read low, the
    mean of a record does not.  Records per call are the records caught
    over ``iters``, rounded, at least 1.  A profile that caught no device
    time is taken again, three times at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.count]
        if not sum(e.self_device_time_total for e in events):
            print(f"    a profile of {iters} calls caught no device time; "
                  f"taken again")
            continue
        per_call, lost = {}, 0
        for e in events:
            k = max(1, round(e.count / iters))
            per_call[e.key] = e.self_device_time_total / e.count * k
            lost += max(0, k * iters - e.count)
        if lost:
            print(f"    the profile of {iters} calls lost {lost} records; "
                  f"timed by the mean of a record")
        return (sum(per_call.values()) / 1e3,
                sum(v for key, v in per_call.items()
                    if "memset" in key.lower()) / 1e3)
    raise RuntimeError("torch.profiler caught no device time in three "
                       "profiles")


def _spmm_bound(nnz, n_in, n_out, d, itemsize=4):
    """Least time the card could take for a sparse product with these
    inputs: the nonzeros (value and source index, 8 B each), the row
    pointers, h read once and the output written once (``itemsize`` bytes
    an element: 2 for bf16), against the fp32 operations the nonzeros
    need (2 per nonzero per column)."""
    nbytes = 8 * nnz + 4 * (n_out + 1) + itemsize * (n_in + n_out) * d
    flops = 2 * nnz * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def _csr_of_tiles(blocks, rows, cols, n_out, n_in):
    """torch's CSR of a plan instance's tiles (its nonzero entries, padded
    rows included): the library yardstick's input, built independently of
    the port's derivation."""
    bs = blocks.shape[-1]
    k, i, j = torch.nonzero(blocks, as_tuple=True)
    idx = torch.stack([rows.long()[k] * bs + i, cols.long()[k] * bs + j])
    return torch.sparse_coo_tensor(idx, blocks[k, i, j], (n_out, n_in),
                                   check_invariants=True).coalesce() \
        .to_sparse_csr()


def timing(bundle, data, dev):
    """Phase 14: returns the numbers of the forward and backward chunk of
    the decoupled path (d = padded classes) and of the naive path's layer-0
    forward chunk (d = padded input features), and the max|Δ| there."""
    from repro_torch.core.decouple import _pad_graph
    from repro_torch.graph.format import rect_block_sparse
    from repro_torch.kernels.spmm import spmm_csr, spmm_csr_ref, spmm_ref
    plan = bundle.graph.bsp.instance(0)
    cs = bundle.graph.chunked.chunk_size
    # chunk 0's tiles as chunk_block_sparse builds them (its stack padding
    # is all-zero tiles, which hold no entry)
    gp = _pad_graph(data.graph, bundle.graph.n_padded)
    e_hi = int(gp.indptr[cs])
    host = rect_block_sparse(gp.dst[:e_hi], gp.src[:e_hi], gp.weight[:e_hi],
                             n_rows=cs, n_cols=gp.n, bs=plan.bs)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, err = {}, 0.0
    for name, t, n_in, n_out, d in (
            ("forward", "", plan.cols_padded, plan.rows_padded,
             bundle.graph.c_padded),
            ("backward", "_t", plan.rows_padded, plan.cols_padded,
             bundle.graph.c_padded),
            ("naive_l0", "", plan.cols_padded, plan.rows_padded,
             bundle.in_dim_padded)):
        arrays = _arrays(plan, t)
        nnz = int(arrays[0][-1])
        h = torch.randn(n_in, d, generator=gen, device=dev)
        tiles = _tiles(host, t, dev)

        def kern():
            return spmm_csr(*arrays, h)

        def plain():
            return spmm_csr_ref(*arrays, h)

        got = kern()
        err = max(err, _held(f"main-path {name} chunk (d={d}) vs tiles",
                             got, spmm_ref(*tiles, h, n_out=n_out)))
        err = max(err, _held(f"  vs the plain version on its arrays", got,
                             plain()))
        if not torch.equal(got, kern()):
            raise AssertionError(f"{name} chunk: a second launch differs "
                                 f"bitwise")
        a_csr = _csr_of_tiles(*tiles, n_out, n_in)
        del tiles

        def lib():
            return torch.sparse.mm(a_csr, h)

        lib_err = _held(f"  torch.sparse.mm (CSR of the tiles) vs kernel",
                        lib(), got)
        k_runs = [_device_ms(kern, 20), _device_ms(kern, 20)]
        k_ms = [t for t, _ in k_runs]
        memset_ms = min(m for _, m in k_runs)
        l_ms = [_device_ms(lib, 20)[0], _device_ms(lib, 20)[0]]
        ev_ms = _time_ms(kern, 20)
        p_ms = _time_ms(plain, 5)
        bound_ms, by, nbytes, flops = _spmm_bound(nnz, n_in, n_out, d)
        rows[name] = dict(
            ms=min(k_ms), ms_runs=k_ms, memset_ms=memset_ms,
            event_ms=ev_ms, plain_ms=p_ms,
            library_ms=min(l_ms), library_ms_runs=l_ms,
            library_err=lib_err, bound_ms=bound_ms, bound_by=by, nnz=nnz,
            n_in=n_in, n_out=n_out, bytes=nbytes, flops=flops)
        print(f"  {name} chunk: {nnz} nonzeros, {n_in}→{n_out} rows, d={d}:"
              f" kernel {k_ms[0]:.4f} / {k_ms[1]:.4f} ms device time, "
              f"the flags' memset {memset_ms:.4f} ms of it "
              f"({ev_ms:.4f} ms a call by CUDA events, host included), "
              f"plain {p_ms:.4f} ms, torch.sparse.mm {l_ms[0]:.4f} / "
              f"{l_ms[1]:.4f} ms device time; bound {bound_ms:.4f} ms by {by}"
              f" ({nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP)")
    return rows, err


# ---------------------------------------------------------------------------
# LM kernels and the Zamba2-2.7B path
# ---------------------------------------------------------------------------

FLASH_CASES = (
    # b, hq, hkv, sq, skv, hd, hdv, dtype, causal, window, softcap
    (2, 8, 8, 256, 256, 64, 64, torch.float32, True, None, None),
    (2, 8, 4, 300, 300, 80, 80, torch.float32, True, None, None),
    (1, 8, 2, 200, 333, 128, 128, torch.float32, False, None, None),
    (1, 8, 1, 257, 257, 256, 256, torch.float32, True, None, None),
    (2, 4, 2, 384, 384, 64, 64, torch.float32, True, 100, None),
    (2, 4, 4, 256, 256, 80, 80, torch.float32, True, None, 20.0),
    (1, 4, 2, 192, 192, 128, 64, torch.float32, True, None, None),
    (1, 4, 4, 130, 70, 64, 64, torch.float32, True, None, None),
    (2, 32, 32, 512, 512, 80, 80, torch.bfloat16, True, None, None),
    (1, 16, 2, 300, 300, 128, 128, torch.bfloat16, True, None, None),
    (1, 8, 4, 256, 400, 256, 256, torch.bfloat16, False, None, None),
    (1, 8, 2, 256, 256, 64, 32, torch.bfloat16, True, 64, 30.0),
    (2, 4, 2, 384, 384, 64, 64, torch.bfloat16, True, 100, None),
    (2, 4, 4, 256, 256, 80, 80, torch.bfloat16, True, None, 20.0),
    (1, 4, 2, 192, 192, 128, 64, torch.bfloat16, True, None, None),
    (1, 4, 4, 130, 70, 64, 64, torch.bfloat16, True, None, None),
    (1, 4, 2, 100, 100, 36, 20, torch.float32, True, None, None),
    (1, 4, 2, 100, 100, 36, 20, torch.bfloat16, True, None, None),
    (1, 8, 1, 257, 257, 256, 256, torch.bfloat16, True, None, None),
    # gemma2's local layers (hd 256, GQA 2, window 4096, softcap 50) past
    # the window, heads cut to 4; MLA's hd 192 (128 + 64 rope) / hd_v 128
    (1, 4, 2, 4608, 4608, 256, 256, torch.float32, True, 4096, 50.0),
    (1, 4, 2, 4608, 4608, 256, 256, torch.bfloat16, True, 4096, 50.0),
    (2, 16, 16, 300, 300, 192, 128, torch.float32, True, None, None),
    (2, 16, 16, 300, 300, 192, 128, torch.bfloat16, True, None, None),
    # InternVL2-1B's GQA 14/2 (g=7) at hd 64 over its 2 304 positions
    (1, 14, 2, 2304, 2304, 64, 64, torch.float32, True, None, None),
    (1, 14, 2, 2304, 2304, 64, 64, torch.bfloat16, True, None, None),
)

SSD_CASES = (
    # b, s, h, p, n, q
    (2, 64, 4, 32, 32, 16),
    (2, 256, 3, 64, 64, 64),
    (1, 512, 5, 64, 128, 256),
    (2, 256, 2, 32, 128, 64),
    (1, 768, 4, 64, 64, 256),
    (2, 128, 8, 32, 64, 16),
    (1, 512, 80, 64, 64, 256),     # the scoring path's widths
    (2, 512, 13, 64, 64, 256),     # H not a multiple of the head group
    (1, 2048, 3, 64, 128, 1024),   # the largest chunk and state
    (2, 192, 5, 20, 40, 96),       # ragged P, N and Q
    (2, 192, 5, 30, 38, 96),       # P, N not multiples of 4: 4-byte copies
)


def flash_cases(dev) -> float:
    """Phase 4; returns the largest max|Δ| over the cases."""
    from repro_torch.kernels.flash_attn import flash_attention_bhsd, flash_ref
    gen = torch.Generator(device=dev).manual_seed(2)
    errs = []
    from repro_torch.kernels.flash_attn.flash import VARIANTS
    for b, hq, hkv, sq, skv, hd, hdv, dt, causal, win, cap in FLASH_CASES:
        q = torch.randn(b, hq, sq, hd, generator=gen, device=dev).to(dt)
        k = torch.randn(b, hkv, skv, hd, generator=gen, device=dev).to(dt)
        v = torch.randn(b, hkv, skv, hdv, generator=gen, device=dev).to(dt)
        kw = dict(causal=causal, window=win, softcap=cap)
        before = dict(flash_attention_bhsd.launches_by_variant)
        got = flash_attention_bhsd(q, k, v, **kw)
        torch.cuda.synchronize()
        ran = {key: n - before[key] for key, n in
               flash_attention_bhsd.launches_by_variant.items()}
        if ran != {key: int(key == VARIANTS[dt]) for key in ran}:
            raise AssertionError(f"{dt} case launched {ran}, expected the "
                                 f"{VARIANTS[dt]} kernel once")
        name = (f"{str(dt)[6:]} g={hq // hkv} {sq}x{skv} hd={hd}/{hdv} "
                f"{'causal' if causal else 'full'}"
                f"{f' win={win}' if win else ''}"
                f"{f' cap={cap:g}' if cap else ''}")
        want = flash_ref(q, k, v, **kw)
        errs.append(_held(name, got, want) if dt == torch.float32
                    else _held_bf16(name, got, want))
    for where in ("q", "k"):
        errs.append(_flash_nan_case(where, gen, dev))
    return max(errs)


def _flash_nan_case(where: str, gen, dev) -> float:
    """A NaN with the card's canonical bits (0x7fffffff) in one element of
    query row i of one head, or of key row j of one kv head, in an fp32
    causal GQA case with a window: the kernel's output must be NaN exactly
    where the plain version's is — row i of that query head; the rows
    that see key j (j ≤ i < j + window) of the heads reading that kv head
    — and is held as the other cases elsewhere.  Returns max|Δ| over the
    finite outputs."""
    from repro_torch.kernels.flash_attn import flash_attention_bhsd, flash_ref
    b, hq, hkv, s, hd = 2, 8, 2, 300, 80
    kw = dict(causal=True, window=200, softcap=None)
    q = torch.randn(b, hq, s, hd, generator=gen, device=dev)
    k = torch.randn(b, hkv, s, hd, generator=gen, device=dev)
    v = torch.randn(b, hkv, s, hd, generator=gen, device=dev)
    nan = torch.tensor([0x7fffffff], dtype=torch.int32,
                       device=dev).view(torch.float32)
    bi, row, col = 1, 150, 17
    if where == "q":
        q[bi, 5, row, col] = nan[0]
        must = (bi, 5, row)
    else:
        k[bi, 1, row, col] = nan[0]
        must = (bi, slice(4, 8), slice(row, row + kw["window"]))
    got = flash_attention_bhsd(q, k, v, **kw)
    want = flash_ref(q, k, v, **kw)
    name = f"fp32 NaN in {where} row {row}"
    if not want[must].isnan().all():
        raise AssertionError(f"{name}: the plain version is finite where "
                             f"the NaN should reach")
    if not torch.equal(got.isnan(), want.isnan()):
        raise AssertionError(
            f"{name}: NaN at {int(got.isnan().sum())} outputs, the plain "
            f"version at {int(want.isnan().sum())}, "
            f"{int((got.isnan() != want.isnan()).sum())} differ")
    print(f"  {name}: NaN at the {int(got.isnan().sum())} outputs the plain "
          f"version puts it, nowhere else")
    fin = ~want.isnan()
    return _held(f"{name}: the finite outputs", got[fin], want[fin])


def _ssd_bound(b, s, h, p, n, q) -> dict:
    """Least time for one SSD intra-chunk call with these shapes: x, dt, a,
    B, C read once and y_intra, the states written once, against the
    operations the function needs (the lower-triangular M·x and the states
    per head, the scores C·Bᵀ once per chunk) as three TF32 passes at the
    tensor-core peak, the kernel's arithmetic; the fp32 FMA time of the
    same operations is returned beside it."""
    nc = s // q
    tri = q * (q + 1) // 2
    flops = b * nc * (h * (2 * tri * p + 2 * q * p * n) + 2 * tri * n)
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n
                  + b * nc * h * p * n)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_tf32 = 3 * flops / PEAK_TF32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_tf32),
            "bound_by": "bytes" if t_bytes >= t_tf32 else "operations",
            "bytes": nbytes, "flops": flops, "t_bytes_ms": t_bytes,
            "t_tf32x3_ms": t_tf32,
            "bound_fp32_ms": flops / PEAK_FP32_FLOP_PER_S * 1e3}


def _ssd_inputs(b, s, h, p, n, gen, dev):
    x = torch.randn(b, s, h, p, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen, device=dev))
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device=dev))
    bm = torch.randn(b, s, n, generator=gen, device=dev) / math.sqrt(n)
    cm = torch.randn(b, s, n, generator=gen, device=dev) / math.sqrt(n)
    return x, dt, a, bm, cm


def _off_by_one_float(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _ssd_nan_case(where: str, gen, dev) -> float:
    """A NaN with the card's canonical bits (0x7fffffff) in one element of
    x or dt, at row k of a chunk: the kernel must give NaN in y_intra at
    every row from k to the chunk's end and in the head's chunk state,
    where the element feeds them (column p of y and row p of the state for
    x[k, p], the head's whole rows and state for dt), and NaN nowhere the
    plain version is finite; elsewhere
    it is held as the other cases.  (The plain version also spreads the NaN
    to rows before k, through 0·NaN in its masked products; the kernel need
    not.)  Returns max|Δ| over the finite outputs."""
    from repro_torch.kernels.ssd import ssd_intra_chunk, ssd_intra_chunk_ref
    b, s, h, p, n, q = 2, 512, 6, 64, 64, 256
    args = list(_ssd_inputs(b, s, h, p, n, gen, dev))
    bi, k, hi, pc = 1, 256 + 150, 5, 7
    nan = torch.tensor([0x7fffffff], dtype=torch.int32,
                       device=dev).view(torch.float32)
    if where == "x":
        args[0][bi, k, hi, pc] = nan[0]
        must_y, must_st = (bi, slice(k, 512), hi, pc), (bi, 1, hi, pc)
    else:
        args[1][bi, k, hi] = nan[0]
        must_y, must_st = (bi, slice(k, 512), hi), (bi, 1, hi)
    y, st = ssd_intra_chunk(*args, chunk=q)
    y_r, st_r = ssd_intra_chunk_ref(*args, chunk=q)
    name = f"NaN in {where} at row {k}, head {hi}"
    for label, got, want, must in (("y_intra", y, y_r, must_y),
                                   ("states", st, st_r, must_st)):
        if not got[must].isnan().all():
            raise AssertionError(f"{name}: {label} lost the NaN")
        if (got.isnan() & ~want.isnan()).any():
            raise AssertionError(f"{name}: {label} NaN where the plain "
                                 f"version is finite")
    fin_y, fin_st = ~y_r.isnan(), ~st_r.isnan()
    return max(_held(f"{name}: y_intra", y[fin_y], y_r[fin_y], SSD_TOL),
               _held("  states", st[fin_st], st_r[fin_st], SSD_TOL))


def ssd_cases(dev) -> float:
    """Phase 5; returns the largest max|Δ| over the cases."""
    from repro_torch.kernels.ssd import (ssd_chunked_fused, ssd_dense_ref,
                                         ssd_intra_chunk, ssd_intra_chunk_ref)
    from repro_torch.nn.ssm import ssd_chunked
    gen = torch.Generator(device=dev).manual_seed(3)
    errs = []
    for b, s, h, p, n, q in SSD_CASES:
        args = _ssd_inputs(b, s, h, p, n, gen, dev)
        y, st = ssd_intra_chunk(*args, chunk=q)
        torch.cuda.synchronize()
        y_r, st_r = ssd_intra_chunk_ref(*args, chunk=q)
        name = f"B={b} S={s} H={h} P={p} N={n} Q={q}"
        errs.append(_held(f"{name} y_intra", y, y_r, SSD_TOL))
        errs.append(_held(f"{name} states", st, st_r, SSD_TOL))
    # x, B and C one float past a 16-byte boundary, P and N multiples of 4
    args = [_off_by_one_float(t) if i in (0, 3, 4) else t
            for i, t in enumerate(_ssd_inputs(2, 256, 5, 64, 64, gen, dev))]
    y, st = ssd_intra_chunk(*args, chunk=128)
    y_r, st_r = ssd_intra_chunk_ref(*args, chunk=128)
    errs.append(_held("unaligned x, B, C: y_intra", y, y_r, SSD_TOL))
    errs.append(_held("  states", st, st_r, SSD_TOL))
    for where in ("x", "dt"):
        errs.append(_ssd_nan_case(where, gen, dev))
    args = _ssd_inputs(2, 600, 4, 64, 64, gen, dev)
    y, final = ssd_chunked_fused(*args, 256)
    y_c, final_c = ssd_chunked(*args, 256)
    errs.append(_held("ssd_chunked_fused S=600 Q=256 vs ssd_chunked", y,
                      y_c, SSD_TOL))
    errs.append(_held("  final state vs ssd_chunked", final, final_c,
                      SSD_TOL))
    errs.append(_held("ssd_chunked_fused S=600 Q=256 vs ssd_dense_ref", y,
                      ssd_dense_ref(*args), SSD_TOL))
    return max(errs)


def _zero_lm_counts():
    from repro_torch.kernels.flash_attn import flash
    from repro_torch.kernels.ssd import ssd_intra_chunk
    flash.reset_launches()
    ssd_intra_chunk.launches = 0


def _read_lm_counts():
    """(flash launches, SSD launches) since the last zeroing; every flash
    launch of the bf16 model paths must be the tensor-core kernel's."""
    from repro_torch.kernels.flash_attn import flash_attention_bhsd as fl
    from repro_torch.kernels.ssd import ssd_intra_chunk
    if fl.launches != fl.launches_by_variant["mma_bf16"]:
        raise AssertionError(f"flash launches {fl.launches_by_variant} are "
                             f"not all the tensor-core kernel's")
    return fl.launches, ssd_intra_chunk.launches


def _flash_case(hd, hdv, window, softcap, variant="mma_bf16") -> str:
    """The name of one key of ``flash_attention_bhsd.launches_by_case``."""
    return f"{variant} hd={hd} hdv={hdv} window={window} softcap={softcap}"


def _flash_case_counts() -> dict:
    """Flash launches since the last zeroing, by case, as counted where
    the wrapper launches its kernel."""
    from repro_torch.kernels.flash_attn import flash_attention_bhsd as fl
    return {_flash_case(hd, hdv, w, c, v): n
            for (v, hd, hdv, w, c), n in fl.launches_by_case.items()}


def _lm_flash_cases(cfg) -> dict:
    """The flash launches one bf16 prefill or scoring forward of ``cfg``
    makes, by case: one per attention layer, windowed on gemma2's local
    layers, at MLA's hd + rope_hd / hdv on DeepSeek's."""
    out = {}
    for kind in cfg.layer_kinds():
        if kind == "mamba":
            continue
        hd = hdv = cfg.head_dim
        if cfg.use_mla:
            hd += cfg.rope_head_dim
        key = _flash_case(hd, hdv, cfg.sliding_window if kind == "local"
                          else None, cfg.attn_softcap)
        out[key] = out.get(key, 0) + 1
    return out


def _plain_lm_kernels():
    """Both LM kernels' plain versions patched in on the card (the
    cross-check only; no entry point falls back to them)."""
    from contextlib import ExitStack

    from repro_torch.kernels.flash_attn import flash_ref
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ssd_intra_chunk_ref
    stack = ExitStack()
    stack.enter_context(mock.patch.object(flash_ops, "flash_attention_bhsd",
                                          flash_ref))
    stack.enter_context(mock.patch.object(ssd_ops, "ssd_intra_chunk",
                                          ssd_intra_chunk_ref))
    return stack


def _expect(what: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"{what}: expected {want}, got {got}")


LM_STEPS = 32          # greedy decode steps of every serving cell
LM_RUNS = 3            # timed prefills and scoring forwards of each cell
LM_XCHECK_STEPS = 8    # greedy steps of the fp32 cross-checks


def _lm_model(arch: str, dev, dtype=torch.float32, **over):
    """``arch`` at full width with the kernels' impls and ``over`` applied,
    random weights from seed 0 drawn on the card in ``dtype`` (norms, the
    MoE router and mamba2's decay rates fp32, as the reference keeps
    them)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_transformer
    from repro_torch.params import tree_leaves

    cfg = dataclasses.replace(get_config(arch), attn_impl="flash",
                              ssm_impl="fused", **over)
    t0 = time.perf_counter()
    params = init_transformer(cfg, seed=0, device=dev, dtype=dtype)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    kinds = cfg.layer_kinds()
    by_kind = ", ".join(f"{kinds.count(k)} {k}" for k in dict.fromkeys(kinds))
    print(f"  {cfg.name}: {cfg.num_layers} layers ({by_kind}), "
          f"d={cfg.d_model}, {n} parameters, {nbytes / 1e9:.2f} GB on the "
          f"card ({str(dtype)[6:]}"
          f"{'' if dtype == torch.float32 else ', norms/router/decay fp32'}"
          f"), initialised in {time.perf_counter() - t0:.1f} s; compute "
          f"{cfg.dtype}")
    return cfg, params, n


def _attn_layers(cfg) -> int:
    """Flash launches of one prefill or scoring forward: one per attention
    layer (mamba layers have none)."""
    return sum(k != "mamba" for k in cfg.layer_kinds())


def _serve_cell(cfg, params, prompt, dev, *, long_context: bool = False,
                prefix=None) -> tuple[np.ndarray, dict]:
    """``generate`` of ``prompt`` (behind ``prefix``, a modality config's
    frontend embeddings) + ``LM_STEPS`` greedy steps, the main path's run,
    with its launches held (one flash launch per attention layer in
    prefill, all of the tensor-core kernel; none in decode; no SSD launch:
    the reference's prefill runs the plain ``ssd_chunked``); then prefill
    and decode timed (medians), one of each profiled, and the peak
    memory.  Behind a prefix the caches' length after prefill is P + S."""
    from repro_torch.serve import generate, make_serve_fns

    b, s = prompt.shape
    off = 0 if prefix is None else prefix.shape[1]
    steps, n_attn = LM_STEPS, _attn_layers(cfg)
    lc = " (long_context: ring caches)" if long_context else ""
    lc += f" behind a {off}-embedding prefix" if off else ""
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_counts()
    t = time.perf_counter()
    res = generate(params, cfg, prompt, steps, prefix=prefix,
                   long_context=long_context, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    counts, cases = _read_lm_counts(), _flash_case_counts()
    print(f"  generate {b} × {s} + {steps} greedy steps{lc} in {gen_s:.2f} "
          f"s; launches flash {counts[0]} ({cases}), ssd {counts[1]}")
    _expect("generate launches (flash, ssd)", counts, (n_attn, 0))
    _expect("generate flash launches by case", cases, _lm_flash_cases(cfg))
    if res.tokens.shape != (b, s + steps) or \
            not torch.isfinite(res.prefill_logits).all():
        raise AssertionError("generate: bad token shape or non-finite "
                             "prefill logits")
    tokens_out = res.tokens
    del res
    print(f"  generated tokens {tokens_out[:, s:s + 8].tolist()} …")

    prefill_fn, decode_fn = make_serve_fns(cfg, long_context=long_context)
    tokens = torch.as_tensor(prompt, device=dev)
    pre_t = None if prefix is None else torch.as_tensor(prefix, device=dev)
    max_len = off + s + steps + 1
    pre_ms, dec_ms = [], []
    with torch.no_grad():
        for _ in range(LM_RUNS):
            logits = caches = None
            _zero_lm_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, caches = prefill_fn(params, tokens, pre_t,
                                        max_len=max_len)
            torch.cuda.synchronize()
            pre_ms.append((time.perf_counter() - t) * 1e3)
            _expect("prefill launches (flash, ssd)", _read_lm_counts(),
                    (n_attn, 0))
        if off:
            _expect("prefill logits' positions", logits.shape[1], off + s)
            _expect("cache length after prefill", caches[0][0].length,
                    off + s)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        logits = None
        _zero_lm_counts()
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step_logits, caches = decode_fn(params, tok, caches)
            tok = torch.argmax(step_logits[:, -1], dim=-1)[:, None].to(
                torch.int32)
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t) * 1e3)
        _expect(f"decode launches over {steps} steps (flash, ssd)",
                _read_lm_counts(), (0, 0))
        prof_dec = _profile(lambda: decode_fn(params, tok, caches),
                            "decode step")
        caches = None
        prof = _profile(lambda: prefill_fn(params, tokens, pre_t,
                                           max_len=max_len), "prefill")
    peak = torch.cuda.max_memory_allocated()
    pre, dec = statistics.median(pre_ms), statistics.median(dec_ms)
    tok_s = b * steps / (sum(dec_ms) / 1e3)
    print(f"  prefill {pre:.2f} ms (median of {pre_ms}); decode "
          f"{dec:.3f} ms per step (median of {steps}); {tok_s:.1f} "
          f"tokens/s over the decode steps (batch {b}); prefill "
          f"{b * (off + s) / (pre / 1e3):.0f} positions/s; peak memory "
          f"{peak / 2**30:.2f} GiB")
    return tokens_out, {
        "generate_s": gen_s, "prefill_ms": pre, "prefill_ms_runs": pre_ms,
        "decode_ms": dec, "decode_ms_runs": dec_ms,
        "decode_tokens_per_s": tok_s, "peak_bytes": peak,
        "launches": {"flash": counts[0], "ssd": counts[1],
                     "flash_by_case": cases},
        "profile": prof, "profile_decode": prof_dec}


def _score_cell(cfg, params, batch, dev, *,
                plain_twin: bool = False) -> dict:
    """``forward`` + ``lm_loss`` on the batch under no_grad (behind its
    ``prefix``, whose positions take no part in the loss, where it has
    one), the main path's run: one flash launch per attention layer and
    one SSD launch per mamba layer, a finite loss (and aux loss); timed,
    profiled, peak memory; with ``plain_twin`` the bf16 loss with both
    plain versions patched in beside it (not gated)."""
    from repro_torch.models import transformer as T
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    targets = torch.as_tensor(batch["targets"], device=dev)
    prefix = batch.get("prefix")
    prefix = None if prefix is None else torch.as_tensor(prefix, device=dev)
    off = 0 if prefix is None else prefix.shape[1]
    b, s = tokens.shape

    def run():
        logits, aux = T.forward(params, cfg, tokens, prefix)
        return T.lm_loss(logits[:, off:], targets), aux

    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        _zero_lm_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, aux = (v.item() for v in run())
        first_ms = (time.perf_counter() - t) * 1e3
        counts, cases = _read_lm_counts(), _flash_case_counts()
        print(f"  scoring loss {loss:.6f} (log V = "
              f"{math.log(cfg.vocab_size):.4f}), aux loss {aux:.6f}; "
              f"launches flash {counts[0]} ({cases}), ssd {counts[1]}; "
              f"first call {first_ms:.1f} ms")
        _expect("scoring launches (flash, ssd)", counts,
                (_attn_layers(cfg), cfg.layer_kinds().count("mamba")))
        _expect("scoring flash launches by case", cases,
                _lm_flash_cases(cfg))
        if not (math.isfinite(loss) and math.isfinite(aux)) or \
                (aux > 0) != cfg.moe:
            raise AssertionError(f"scoring loss {loss} / aux {aux}: not "
                                 f"finite, or an aux loss where no MoE "
                                 f"layer is (or none where one is)")
        ms = []
        for _ in range(LM_RUNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()[0].item()
            ms.append((time.perf_counter() - t) * 1e3)
        prof = _profile(run, "scoring forward")
        out = {}
        if plain_twin:
            with _plain_lm_kernels():
                out["loss_plain"] = run()[0].item()
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(ms)
    print(f"  scoring {med:.2f} ms (median of {ms}); "
          f"{b * s / (med / 1e3):.0f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB"
          + (f"; bf16 loss kernel vs plain versions |Δ|="
             f"{abs(loss - out['loss_plain']):.3e} (plain "
             f"{out['loss_plain']:.6f}; not gated)" if plain_twin else ""))
    return {"loss": loss, "aux": aux, "ms": med, "ms_runs": ms,
            "peak_bytes": peak,
            "launches": {"flash": counts[0], "ssd": counts[1],
                         "flash_by_case": cases},
            "profile": prof, **out}


def serve(dev):
    """Phases 16–17: Zamba2-2.7B full width, bf16 compute on fp32 weights:
    generate + timing, then scoring."""
    from repro_torch.data import SyntheticLM
    cfg, params, n_params = _lm_model("zamba2-2.7b", dev)
    batch = next(SyntheticLM(cfg.vocab_size, seed=0).batches(2, 2048))
    _, info = _serve_cell(cfg, params, batch["tokens"], dev)
    print("[17/31] LM main path, scoring: forward + lm_loss")
    score_info = _score_cell(cfg, params, batch, dev, plain_twin=True)
    return cfg, params, batch, {"params": n_params, **info}, score_info


def cross_check_fp32(cfg, params, prompt, targets, dev, *,
                     long_contexts=(False,)) -> tuple:
    """The kernel path against the same path with both plain versions
    patched in, on the card, in fp32: ``generate`` of ``prompt`` +
    ``LM_XCHECK_STEPS`` greedy steps at each of ``long_contexts`` — prefill
    logits within 1e-4·max|ref|, identical tokens — and the scoring loss
    within 1e-5 relative.  The kernel path must launch the kernels (fp32:
    the three-pass TF32 flash kernel) and the plain one none.  Returns the
    largest logits max|Δ|, the fp32 flash launches the kernel path counted
    and those launches by case (``_flash_case_counts``)."""
    import dataclasses

    from repro_torch.kernels.flash_attn import flash_attention_bhsd as fl
    from repro_torch.kernels.ssd import ssd_intra_chunk
    from repro_torch.models import transformer as T
    from repro_torch.serve import generate
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b, s = prompt.shape
    tokens = torch.as_tensor(prompt, device=dev)
    targets = torch.as_tensor(targets, device=dev)

    def run():
        _zero_lm_counts()
        res = [generate(params, cfg32, prompt, LM_XCHECK_STEPS,
                        long_context=lc, device=dev) for lc in long_contexts]
        with torch.no_grad():
            logits, _ = T.forward(params, cfg32, tokens)
            loss = T.lm_loss(logits, targets).item()
        return res, loss, (fl.launches_by_variant["mma_tf32x3"],
                           ssd_intra_chunk.launches)

    res_k, loss_k, ran_k = run()
    by_case = _flash_case_counts()
    with _plain_lm_kernels():
        res_p, loss_p, ran_p = run()
    n_attn, n_mamba = _attn_layers(cfg), cfg.layer_kinds().count("mamba")
    _expect(f"{cfg.name} fp32 kernel-path launches (flash fp32, ssd)", ran_k,
            ((len(long_contexts) + 1) * n_attn, n_mamba))
    _expect(f"{cfg.name} plain-path launches", ran_p, (0, 0))
    err = 0.0
    for lc, rk, rp in zip(long_contexts, res_k, res_p):
        tag = f"{cfg.name} fp32 {b}×{s}{' long_context' if lc else ''}"
        err = max(err, _held(f"{tag} prefill logits, kernels vs plain",
                             rk.prefill_logits, rp.prefill_logits,
                             PATH_RTOL, 0.0))
        if not np.array_equal(rk.tokens, rp.tokens):
            raise AssertionError(f"{tag} greedy tokens differ: "
                                 f"{rk.tokens[:, s:]} vs {rp.tokens[:, s:]}")
        print(f"  {tag} greedy tokens identical over {LM_XCHECK_STEPS} "
              f"steps: {rk.tokens[0, s:].tolist()}")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  {cfg.name} fp32 scoring loss {b}×{s}: kernels {loss_k:.7f}, "
          f"plain {loss_p:.7f}, relative |Δ| {rel:.2e}  "
          f"{'ok' if rel <= 1e-5 else 'FAIL'}")
    if rel > 1e-5:
        raise AssertionError(f"{cfg.name} fp32 scoring loss differs by "
                             f"{rel:.2e}")
    return err, ran_k[0], by_case


def _flash_bound(b, hq, hkv, s, hd, hdv, window) -> dict:
    """Least time for one bf16 causal flash call: q, k, v read once and the
    output written once, against 2·(hd + hd_v) operations per visible
    (query, key) pair per query head at the bf16 tensor-core peak (the
    fp32 peak's time beside).  A causal row i sees min(i + 1, window)
    keys."""
    w = window or s
    pairs = w * (w + 1) // 2 + (s - w) * w if s > w else s * (s + 1) // 2
    flops = 2 * (hd + hdv) * pairs * hq * b
    nbytes = 2 * (b * hq * s * hd + b * hkv * s * (hd + hdv)
                  + b * hq * s * hdv)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_bf16 = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_bf16),
            "bound_by": "bytes" if t_bytes >= t_bf16 else "operations",
            "bytes": nbytes, "flops": flops, "pairs": pairs,
            "t_bytes_ms": t_bytes,
            "bound_fp32_ms": flops / PEAK_FP32_FLOP_PER_S * 1e3}


def _flex_attention(q, k, v, *, window, softcap, scale):
    """``flex_attention`` compiled, computing the flash kernel's function:
    ``softcap·tanh(s/softcap)`` as its score_mod, the causal (and window)
    mask as its block mask, GQA by ``enable_gqa``.  The library yardstick
    of the softcapped and windowed shapes (SDPA has no softcap); the port
    never calls it."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    s = q.shape[2]

    def visible(b, h, qi, ki):
        if window:
            return (ki <= qi) & (ki > qi - window)
        return ki <= qi

    def capped(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    mask = create_block_mask(visible, None, None, s, s, device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda: flex(q, k, v, score_mod=capped if softcap else None,
                        block_mask=mask, scale=scale, enable_gqa=True)


def _flash_row(gen, dev, b, hq, hkv, s, hd, hdv, *, window=None,
               softcap=None, scale=None) -> dict:
    """One bf16 flash launch at a path's shape: held against the plain
    version, timed (CUDA events, two runs) beside the plain version and the library yardstick on the same
    tensors — ``scaled_dot_product_attention``, or with a softcap or a
    window the compiled ``flex_attention`` — held for agreement to
    1e-2·(1 + max|ref|) and timed, never on the path."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import (flash_attention_bhsd,
                                                flash_ref, hbm_bytes_model)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev)
               .to(torch.bfloat16)
               for h, d in ((hq, hd), (hkv, hd), (hkv, hdv)))
    kw = dict(window=window, softcap=softcap, scale=scale)
    name = (f"flash ({b},{hq},{s},{hd}{f'/{hdv}' if hdv != hd else ''}) "
            f"g={hq // hkv}{f' win={window}' if window else ''}"
            f"{f' cap={softcap:g}' if softcap else ''}")
    got = flash_attention_bhsd(q, k, v, **kw)
    err = _held_bf16(f"{name} bf16 causal vs plain", got,
                     flash_ref(q, k, v, **kw))
    if softcap is None and window is None:
        library, lib_name = (lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True)), "SDPA"
    else:
        library, lib_name = _flex_attention(q, k, v, window=window,
                                            softcap=softcap, scale=scale), \
            "flex_attention"
    t = time.perf_counter()
    lib_out = library()
    torch.cuda.synchronize()
    lib_first_s = time.perf_counter() - t     # flex_attention: its compile
    lib_err = _held(f"  {lib_name} vs kernel", lib_out.float(), got.float(),
                    SDPA_TOL)
    del lib_out, got
    bd = _flash_bound(b, hq, hkv, s, hd, hdv, window)
    k_ms = _time_ms(lambda: flash_attention_bhsd(q, k, v, **kw), 10)
    p_ms = _time_ms(lambda: flash_ref(q, k, v, **kw), 3)
    l_ms = _time_ms(library, 20)
    k_ms2 = _time_ms(lambda: flash_attention_bhsd(q, k, v, **kw), 10)
    row = dict(shape=[b, hq, hkv, s, hd, hdv], window=window,
               softcap=softcap, ms=min(k_ms, k_ms2), ms_runs=[k_ms, k_ms2],
               plain_ms=p_ms, library_ms=l_ms, library=lib_name,
               library_first_s=lib_first_s, max_abs_err=err,
               library_err=lib_err, **bd)
    print(f"  {name} bf16 causal: kernel {k_ms:.4f} / {k_ms2:.4f} ms, "
          f"plain {p_ms:.4f} ms, {lib_name} {l_ms:.4f} ms (first call "
          f"{lib_first_s:.1f} s); bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']} ({bd['flops'] / 1e9:.2f} GFLOP over "
          f"{bd['pairs']} visible pairs a head at the bf16 tensor-core "
          f"peak, {bd['bound_fp32_ms']:.4f} ms at the fp32 peak; "
          f"{bd['bytes'] / 1e6:.1f} MB, {bd['t_bytes_ms']:.4f} ms)")
    row.update(_modeled(hbm_bytes_model(b, hq, hkv, s, s, hd, hdv,
                                        itemsize=2, causal=True,
                                        window=window), row["ms"]))
    return row


def _modeled(nbytes: int, ms: float) -> dict:
    """Print and return the bytes a kernel's schedule requests
    (``hbm_bytes_model``) and the rate they imply at the measured time;
    the rate may pass the card's 3.35 TB/s where re-reads hit L2."""
    gb_s = nbytes / (ms * 1e-3) / 1e9
    print(f"    hbm_bytes_model: {nbytes / 1e6:.1f} MB requested, "
          f"{gb_s:.1f} GB/s at {ms:.4f} ms")
    return {"model_bytes": nbytes, "model_gb_s": gb_s}


def _flash_tf32x3_bound(b, hq, hkv, s, hd, hdv, window) -> dict:
    """Least time for one fp32 causal flash call: q, k, v read once and the
    output written once in fp32, against 2·(hd + hd_v) operations per
    visible (query, key) pair per query head as three TF32 passes at the
    tensor-core peak, the kernel's arithmetic; the time of the same
    operations at the fp32 CUDA-core peak is returned beside it."""
    bd = _flash_bound(b, hq, hkv, s, hd, hdv, window)
    nbytes = 2 * bd["bytes"]                  # fp32: 4 bytes an element
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_tf32 = 3 * bd["flops"] / PEAK_TF32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_tf32),
            "bound_by": "bytes" if t_bytes >= t_tf32 else "operations",
            "bytes": nbytes, "flops": bd["flops"], "pairs": bd["pairs"],
            "t_bytes_ms": t_bytes, "t_tf32x3_ms": t_tf32,
            "bound_fp32_ms": bd["bound_fp32_ms"]}


# the fp32 flash rows of phase 19: key, (b, hq, hkv, s, hd, hdv), window,
# softcap, scale — the shapes the fp32 cross-checks launch the kernel at
# (phase 18's Zamba2, phase 25's gemma2 global and local layers and
# DeepSeek's MLA) and Zamba2's at its full prefill
FLASH_FP32_ROWS = (
    ("flash_fp32", (1, 32, 32, 512, 80, 80), None, None, None),
    ("flash_fp32_zamba2", (2, 32, 32, 2048, 80, 80), None, None, None),
    ("flash_fp32_gemma2_global", (1, 16, 8, 4608, 256, 256), None, 50.0,
     None),
    ("flash_fp32_gemma2_local", (1, 16, 8, 4608, 256, 256), 4096, 50.0,
     None),
    ("flash_fp32_mla", (1, 16, 16, 512, 192, 128), None, None, 192 ** -0.5),
)


def _flash_fp32_row(gen, dev, b, hq, hkv, s, hd, hdv, *, window=None,
                    softcap=None, scale=None, library=True) -> dict:
    """The fp32 flash kernel (``flash_attention_tf32x3.cu``) at one shape,
    causal, held against the plain version at 1e-5·(1 + max|ref|), timed
    (CUDA events, two runs) beside the plain version and, unless
    ``library`` is False, the library yardstick in fp32 on the same
    tensors — SDPA, or with a softcap or a window the compiled
    ``flex_attention`` — held for agreement at the same tolerance
    (``flex_attention`` at 1e-2·(1 + max|ref|), as in the bf16 rows); its
    bound from ``_flash_tf32x3_bound``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import (flash_attention_bhsd,
                                                flash_ref, hbm_bytes_model)
    q = torch.randn(b, hq, s, hd, generator=gen, device=dev)
    k = torch.randn(b, hkv, s, hd, generator=gen, device=dev)
    v = torch.randn(b, hkv, s, hdv, generator=gen, device=dev)
    kw = dict(window=window, softcap=softcap, scale=scale)
    name = (f"flash fp32 ({b},{hq},{s},{hd}{f'/{hdv}' if hdv != hd else ''})"
            f" g={hq // hkv}{f' win={window}' if window else ''}"
            f"{f' cap={softcap:g}' if softcap else ''}")
    got = flash_attention_bhsd(q, k, v, **kw)
    err = _held(f"{name} causal vs plain", got, flash_ref(q, k, v, **kw))
    lib = lib_name = lib_err = l_ms = None
    if library:
        if softcap is None and window is None:
            lib_name = "SDPA fp32"
            lib = (lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale, enable_gqa=True))
        else:
            lib_name = "flex_attention fp32"
            lib = _flex_attention(q, k, v, window=window, softcap=softcap,
                                  scale=scale)
        # SDPA's fp32 kernels are held as the kernel is; the compiled
        # flex_attention only for agreement, as in the bf16 rows (its Triton
        # dots may run in TF32)
        lib_err = _held(f"  {lib_name} vs kernel", lib(), got,
                        KERNEL_TOL if softcap is None and window is None
                        else SDPA_TOL)
    del got
    bd = _flash_tf32x3_bound(b, hq, hkv, s, hd, hdv, window)
    iters = 20 if bd["flops"] < 1e10 else 5
    k_ms = _time_ms(lambda: flash_attention_bhsd(q, k, v, **kw), iters)
    p_ms = _time_ms(lambda: flash_ref(q, k, v, **kw), 3)
    if lib:
        l_ms = _time_ms(lib, iters)
    k_ms2 = _time_ms(lambda: flash_attention_bhsd(q, k, v, **kw), iters)
    row = dict(shape=[b, hq, hkv, s, hd, hdv], window=window,
               softcap=softcap, ms=min(k_ms, k_ms2), ms_runs=[k_ms, k_ms2],
               plain_ms=p_ms, library_ms=l_ms, library=lib_name,
               max_abs_err=err, library_err=lib_err, **bd)
    lib_txt = f"{lib_name} {l_ms:.4f} ms" if lib else "no library timed"
    print(f"  {name}: kernel {k_ms:.4f} / {k_ms2:.4f} ms, plain "
          f"{p_ms:.4f} ms, {lib_txt}; bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']} ({bd['flops'] / 1e9:.3f} GFLOP: three TF32 "
          f"passes at the tensor-core peak {bd['t_tf32x3_ms']:.4f} ms, at "
          f"the fp32 CUDA-core peak {bd['bound_fp32_ms']:.4f} ms; "
          f"{bd['bytes'] / 1e6:.1f} MB, {bd['t_bytes_ms']:.4f} ms)")
    row.update(_modeled(hbm_bytes_model(b, hq, hkv, s, s, hd, hdv,
                                        causal=True, window=window),
                        row["ms"]))
    return row


def flash_fp32_timing(gen, dev, *, library=True) -> dict:
    """Phase 19's fp32 flash rows (``FLASH_FP32_ROWS``)."""
    rows = {}
    for key, shape, window, softcap, scale in FLASH_FP32_ROWS:
        rows[key] = _flash_fp32_row(gen, dev, *shape, window=window,
                                    softcap=softcap, scale=scale,
                                    library=library)
        torch.cuda.empty_cache()
    return rows


def _ssd_row(gen, dev, bsz, s, h, p, n, qc) -> dict:
    """One SSD launch at a path's shape held against the plain version,
    device time (``torch.profiler``, two runs) with its CUDA-event time
    beside, the plain version and the bound."""
    from repro_torch.kernels.ssd import (hbm_bytes_model, ssd_intra_chunk,
                                         ssd_intra_chunk_ref)
    args = _ssd_inputs(bsz, s, h, p, n, gen, dev)
    name = f"ssd ({bsz},{s},{h},{p}) N={n} Q={qc}"
    y, st = ssd_intra_chunk(*args, chunk=qc)
    y_r, st_r = ssd_intra_chunk_ref(*args, chunk=qc)
    err = max(_held(f"{name} y_intra vs plain", y, y_r, SSD_TOL),
              _held("  states vs plain", st, st_r, SSD_TOL))
    del y, st, y_r, st_r

    def kern():
        return ssd_intra_chunk(*args, chunk=qc)

    k_ms = [_device_ms(kern, 10)[0], _device_ms(kern, 10)[0]]
    ev_ms = _time_ms(kern, 10)
    p_ms = _time_ms(lambda: ssd_intra_chunk_ref(*args, chunk=qc), 3)
    bd = _ssd_bound(bsz, s, h, p, n, qc)
    print(f"  {name}: kernel {k_ms[0]:.4f} / {k_ms[1]:.4f} ms device time "
          f"({ev_ms:.4f} ms a call by CUDA events), plain {p_ms:.4f} ms; "
          f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
          f"({bd['bytes'] / 1e6:.1f} MB, {bd['t_bytes_ms']:.4f} ms; "
          f"{bd['flops'] / 1e9:.3f} GFLOP in the lower-triangular products, "
          f"the states and the scores, as three TF32 passes "
          f"{bd['t_tf32x3_ms']:.4f} ms, in fp32 FMA "
          f"{bd['bound_fp32_ms']:.4f} ms)")
    return dict(shape=[bsz, s, h, p, n, qc], ms=min(k_ms), ms_runs=k_ms,
                event_ms=ev_ms, plain_ms=p_ms, library_ms=None,
                max_abs_err=err, **bd,
                **_modeled(hbm_bytes_model(bsz, s, h, p, n, chunk=qc),
                           min(k_ms)))


def lm_timing(dev):
    """Phase 19: one flash launch at each LM path's shape — Zamba2's
    (2, 32, 2048, 80), gemma2's global (1, 16, 8192, 256) softcap 50 and
    local (the same, window 4096) layers, DeepSeek's MLA (2, 16, 2048,
    192/128), InternVL2's (2, 14, 2304, 64) g=7 and MusicGen's (2, 32,
    2112, 64) — the fp32 flash rows (``FLASH_FP32_ROWS``) and one SSD
    launch at Zamba2's (2, 2048, 80, 64) N=64 and Mamba2-1.3B's (2, 2048,
    64, 64) N=128."""
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = {"flash": _flash_row(gen, dev, 2, 32, 32, 2048, 80, 80)}
    for key, win in (("flash_gemma2_global", None),
                     ("flash_gemma2_local", 4096)):
        rows[key] = _flash_row(gen, dev, 1, 16, 8, 8192, 256, 256,
                               window=win, softcap=50.0)
        torch.cuda.empty_cache()
    rows["flash_mla"] = _flash_row(gen, dev, 2, 16, 16, 2048, 192, 128,
                                   scale=192 ** -0.5)
    # the modality configs' prefills: 256 + 2048 and 64 + 2048 positions
    rows["flash_internvl2"] = _flash_row(gen, dev, 2, 14, 2, 2304, 64, 64)
    rows["flash_musicgen"] = _flash_row(gen, dev, 2, 32, 32, 2112, 64, 64)
    rows.update(flash_fp32_timing(gen, dev))
    rows["ssd"] = _ssd_row(gen, dev, 2, 2048, 80, 64, 64, 256)
    rows["ssd_n128"] = _ssd_row(gen, dev, 2, 2048, 64, 64, 128, 256)
    return rows


# ---------------------------------------------------------------------------
# Gemma2-9B, DeepSeek-V2-Lite, Mamba2-1.3B and the fp32 cross-checks
# (phases 22–25)
# ---------------------------------------------------------------------------

def _lm_free() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def gemma2(dev) -> dict:
    """Phase 22: gemma2-9b at full width and depth, bf16 weights."""
    from repro_torch.data import SyntheticLM
    cfg, params, n = _lm_model("gemma2-9b", dev, torch.bfloat16)
    batch = next(SyntheticLM(cfg.vocab_size, seed=0).batches(1, 8192))
    out = {"params": n}
    for lc in (True, False):
        out[f"serve_long_context_{lc}"] = _serve_cell(
            cfg, params, batch["tokens"], dev, long_context=lc)[1]
    out["score"] = _score_cell(cfg, params, batch, dev)
    del params
    _lm_free()
    return out


def _moe_drops(cfg, params, tokens) -> dict:
    """Assignments MoE drops in one prefill at the capacity factor: each
    MoE layer's routing of its input against the capacity (an expert keeps
    its first C assignments)."""
    from repro_torch.models import transformer as T
    from repro_torch.nn import moe as moe_lib
    seen = []
    apply = moe_lib.moe_apply

    def counting(p, cfg_, x, **kw):
        xf = x.reshape(-1, x.shape[-1])
        top_e = moe_lib.route(p, cfg_, xf)[2]
        per_expert = torch.bincount(top_e.reshape(-1),
                                    minlength=cfg_.num_experts)
        cap = moe_lib.capacity(cfg_, xf.shape[0])
        seen.append((int((per_expert - cap).clamp_min(0).sum()),
                     top_e.numel()))
        return apply(p, cfg_, x, **kw)

    with torch.no_grad(), mock.patch.object(moe_lib, "moe_apply", counting):
        T.prefill(params, cfg, tokens, max_len=tokens.shape[1])
    t = tokens.numel()
    cap = moe_lib.capacity(cfg, t)
    lost = sum(d for d, _ in seen)
    total = sum(a for _, a in seen)
    print(f"  MoE at prefill ({len(seen)} layers): T·k = "
          f"{t * cfg.num_experts_per_tok} assignments a layer against E·C "
          f"= {cfg.num_experts} × {cap} = {cfg.num_experts * cap} slots "
          f"(capacity factor {cfg.moe_capacity_factor}); dropped {lost} of "
          f"{total} ({lost / total:.4%}), by layer {[d for d, _ in seen]}")
    return {"capacity": cap, "dropped": lost, "assignments": total,
            "by_layer": [d for d, _ in seen]}


def deepseek(dev) -> dict:
    """Phase 23: deepseek-v2-lite-16b at full width and depth, bf16
    weights."""
    from repro_torch.data import SyntheticLM
    cfg, params, n = _lm_model("deepseek-v2-lite-16b", dev, torch.bfloat16)
    batch = next(SyntheticLM(cfg.vocab_size, seed=0).batches(2, 2048))
    out = {"params": n}
    out["serve"] = _serve_cell(cfg, params, batch["tokens"], dev)[1]
    out["moe"] = _moe_drops(cfg, params,
                            torch.as_tensor(batch["tokens"], device=dev))
    out["score"] = _score_cell(cfg, params, batch, dev)
    del params
    _lm_free()
    return out


def mamba2(dev) -> dict:
    """Phase 24: mamba2-1.3b at full width and depth (fp32 weights, bf16
    compute, as Zamba2's)."""
    from repro_torch.data import SyntheticLM
    cfg, params, n = _lm_model("mamba2-1.3b", dev)
    batch = next(SyntheticLM(cfg.vocab_size, seed=0).batches(2, 2048))
    out = {"params": n}
    out["score"] = _score_cell(cfg, params, batch, dev)
    out["serve"] = _serve_cell(cfg, params, batch["tokens"], dev)[1]
    del params
    _lm_free()
    return out


# arch, overrides, prompt length, long_context settings
LM_XCHECKS = (
    ("gemma2-9b", dict(num_layers=4), 4608, (True, False)),
    ("deepseek-v2-lite-16b", dict(num_layers=3), 512, (False,)),
    ("mamba2-1.3b", dict(num_layers=4), 512, (False,)),
    ("granite-moe-1b-a400m-reduced", {}, 512, (False,)),
    ("minitron-8b-reduced", {}, 512, (False,)),
    ("internlm2-1.8b-reduced", {}, 512, (False,)),
    ("qwen1.5-4b-reduced", {}, 512, (False,)),
)


def lm_cross_checks(dev) -> dict:
    """Phase 25: the fp32 kernels-vs-plain cross-check (phase 18's) on the
    new configs, under deterministic algorithms (MoE's ``index_add_`` and
    ``index_put_`` then sum in a fixed order).  Returns each config's
    logits max|Δ|, the fp32 flash launches counted and those launches by
    case."""
    from repro_torch.data import SyntheticLM
    out, launches, by_case = {}, 0, {}
    with _deterministic("phase 25"):
        for arch, over, s, lcs in LM_XCHECKS:
            cfg, params, _ = _lm_model(arch, dev, **over)
            batch = next(SyntheticLM(cfg.vocab_size, seed=1).batches(1, s))
            torch.cuda.reset_peak_memory_stats()
            out[cfg.name], n, cases = cross_check_fp32(
                cfg, params, batch["tokens"], batch["targets"], dev,
                long_contexts=lcs)
            launches += n
            for key, c in cases.items():
                by_case[key] = by_case.get(key, 0) + c
            print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                  f" GiB")
            del params
            _lm_free()
    return out, launches, by_case


# ---------------------------------------------------------------------------
# The modality configs' serving and LM training (phases 26–27)
# ---------------------------------------------------------------------------

MM_ARCHS = ("internvl2-1b", "musicgen-large")


def multimodal(dev) -> dict:
    """Phase 26: InternVL2-1B and MusicGen-large at full width and depth,
    bf16 weights (norms fp32), ``attn_impl="flash"``: ``generate`` of 2 ×
    2048 ``SyntheticLM`` tokens behind the config's prefix (its normal
    draws from ``batches(cfg=)``) + 32 greedy steps, and scoring on the
    prefixed batch."""
    from repro_torch.data import SyntheticLM
    out = {}
    for arch in MM_ARCHS:
        cfg, params, n = _lm_model(arch, dev, torch.bfloat16)
        batch = next(SyntheticLM(cfg.vocab_size, seed=0).batches(2, 2048,
                                                                 cfg))
        print(f"  prefix {batch['prefix'].shape} fp32 through mm_proj")
        out[arch] = {
            "params": n,
            "serve": _serve_cell(cfg, params, batch["tokens"], dev,
                                 prefix=batch["prefix"])[1],
            "score": _score_cell(cfg, params, batch, dev)}
        del params
        _lm_free()
    return out


TRAIN_ARCHS = ("internvl2-1b", "granite-moe-1b-a400m")
TRAIN_LR = 3e-4
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
TRAIN_MEMORY_SHARE = 0.8    # of the card's memory a chosen batch may take
TRAIN_XCHECK = dict(num_layers=2, dtype="float32")
TRAIN_XCHECK_SEQ = 512
TRAIN_RTOL = 1e-4           # the card's fp32 steps against the CPU's
REMAT_RTOL = 1e-6           # remat True / False / "dots" against each other


def _train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6·N·T over the T = batch·(P + seq)
    positions, N the parameters that enter a matmul for each position (a
    MoE layer's active experts and its router; the unembed, tied or not,
    at the padded vocabulary; not the embedding's gather), plus 6·d²·P a
    sequence for ``mm_proj`` and 12·L·H·hd·S² a sequence for attention's
    two products over its S = P + seq positions.  No recompute counted."""
    p = cfg.num_prefix_embeddings if cfg.modality else 0
    d, s_all = cfg.d_model, p + seq
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    n = cfg.active_param_count() - embed + cfg.padded_vocab * d
    n_attn = sum(k != "mamba" for k in cfg.layer_kinds())
    return batch * (6 * n * s_all + 6 * d * d * p
                    + 12 * n_attn * cfg.num_heads * cfg.head_dim * s_all ** 2)


def _train_state(params, opt):
    """A fresh train state on clones of ``params``."""
    from repro_torch.params import tree_map
    from repro_torch.train import init_train_state
    return init_train_state(tree_map(torch.clone, params), opt)


def _grad_peak(cfg, state, batch, remat) -> int:
    """Peak memory of a step's forward and backward (the gradient, before
    the optimizer's update) on ``batch`` beside ``state``."""
    from repro_torch.params import tree_leaves, tree_unflatten
    from repro_torch.train import make_loss_fn
    _lm_free()
    torch.cuda.reset_peak_memory_stats()
    live = [t.detach().requires_grad_() for t in tree_leaves(state.params)]
    total, _ = make_loss_fn(cfg, remat=remat)(
        tree_unflatten(state.params, live), batch)
    grads = torch.autograd.grad(total, live)
    del total, grads, live
    return torch.cuda.max_memory_allocated()


def _choose_batch(cfg, state, data_fn, dev) -> tuple[int, dict]:
    """The largest batch (≤ train_4k's 256) whose forward and backward are
    predicted to fit in ``TRAIN_MEMORY_SHARE`` of the card beside the
    train state: their measured peaks at remat=True and batch 1 and 2 (a
    peak affine in the batch); and remat=False's batch from its peak at
    batch 1 over the same intercept.  (The optimizer's update peaks apart,
    at a size set by the parameters alone.)"""
    limit = TRAIN_MEMORY_SHARE * torch.cuda.get_device_properties(
        dev).total_memory
    p1 = _grad_peak(cfg, state, data_fn(1), True)
    p2 = _grad_peak(cfg, state, data_fn(2), True)
    slope, base = p2 - p1, 2 * p1 - p2
    if slope <= 0:
        raise AssertionError(f"{cfg.name}: peaks {p1}, {p2} at batch 1, 2 "
                             f"do not grow with the batch")
    b_true = min(256, int((limit - base) // slope))
    f1 = _grad_peak(cfg, state, data_fn(1), False)
    b_false = min(256, int((limit - base) // (f1 - base)))
    print(f"  forward + backward peak (remat=True) at batch 1 / 2: "
          f"{p1 / 2**30:.2f} / {p2 / 2**30:.2f} GiB ({slope / 2**30:.2f} "
          f"GiB a sequence over {base / 2**30:.2f}); remat=False at batch 1 "
          f"{f1 / 2**30:.2f} GiB; within {limit / 2**30:.1f} GiB the batch "
          f"is {b_true} (remat=True), {b_false} (remat=False)")
    if b_true < 1:
        raise AssertionError(f"{cfg.name}: no batch fits one card")
    return b_true, {"peak_b1": p1, "peak_b2": p2, "peak_b1_no_remat": f1,
                    "batch_no_remat": b_false, "limit_bytes": limit}


def _train_cell(arch, dev, card: str) -> dict:
    """``make_train_step(cfg, adamw(3e-4), remat=True)`` at full width and
    depth on the config's defaults (naive attention, jnp SSD: no kernel;
    bf16 compute over fp32 parameters) at train_4k's sequence length,
    behind the prefix where the config has one, at the batch one card
    holds: 3 warm-up + 10 timed steps on fresh ``SyntheticLM`` batches,
    finite and falling loss, a finite aux loss, no kernel launch; every
    MoE router moved (its gradient nonzero); the median step, tokens/s,
    MFU, one profiled step, peak memory; InternVL2's peaks at remat=False
    and ``"dots"`` beside remat=True's at the batch remat=False fits
    (forward and backward)."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.data import SyntheticLM
    from repro_torch.models.transformer import init_transformer
    from repro_torch.optim import adamw
    from repro_torch.params import tree_leaves
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_config(arch)
    seq = get_shape("train_4k").seq_len
    opt = adamw(TRAIN_LR)
    state = init_train_state(init_transformer(cfg, seed=0, device=dev), opt)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(state.params))
    print(f"  {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, {n} fp32 "
          f"parameters ({n * 16 / 1e9:.2f} GB with gradients and AdamW's "
          f"two moments), compute {cfg.dtype}, attn_impl={cfg.attn_impl}, "
          f"ssm_impl={cfg.ssm_impl}, {seq} tokens"
          + (f" behind {cfg.num_prefix_embeddings} prefix embeddings"
             if cfg.modality else ""))
    data = SyntheticLM(cfg.vocab_size, seed=0)

    def data_fn(b):
        return next(data.batches(b, seq, cfg))

    batch_size, probe = _choose_batch(cfg, state, data_fn, dev)
    print(f"  train_4k's global batch of 256 cut to {batch_size} sequences "
          f"(one card)")
    routers = [t.clone() for t in _routers(state.params)]
    _lm_free()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, opt, remat=True)
    batches = [data_fn(batch_size) for _ in range(TRAIN_WARMUP + TRAIN_STEPS
                                                   + 1)]
    losses, auxes, ms = [], [], []
    _zero_lm_counts()
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batches[i])
        losses.append(m["loss"].item())
        auxes.append(m["aux_loss"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    counts = _read_lm_counts()
    _expect(f"{cfg.name} training launches (flash, ssd)", counts, (0, 0))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses + auxes) or \
            losses[-1] >= losses[0] or (auxes[0] > 0) != cfg.moe:
        raise AssertionError(f"{cfg.name} training: losses {losses}, aux "
                             f"{auxes}: not finite, not falling, or an aux "
                             f"loss where no MoE layer is (or none where "
                             f"one is)")
    moved = [bool((a != b).any()) for r0, r1 in zip(routers,
                                                      _routers(state.params))
             for a, b in zip(r0, r1)]
    if not all(moved):
        raise AssertionError(f"{cfg.name}: routers that never moved (zero "
                             f"gradient) at layers "
                             f"{[i for i, m in enumerate(moved) if not m]}")
    holder = [state]

    def one_step():
        holder[0], m = step(holder[0], batches[-1])
        m["loss"].item()
    prof = _profile(one_step, f"{cfg.name} train step")
    med = statistics.median(ms[TRAIN_WARMUP:])
    flops = _train_flops(cfg, batch_size, seq)
    positions = batch_size * (seq + (cfg.num_prefix_embeddings
                                     if cfg.modality else 0))
    mfu = flops / (med / 1e3) / PEAK_BF16_FLOP_PER_S
    print(f"  losses {[round(v, 4) for v in losses]}; aux "
          f"{[round(v, 5) for v in auxes]}; launches flash {counts[0]}, ssd "
          f"{counts[1]}" + (f"; all {len(moved)} routers moved"
                            if moved else ""))
    print(f"  step {med:.2f} ms (median of {TRAIN_STEPS} after "
          f"{TRAIN_WARMUP} warm-up: {[round(v, 2) for v in ms]}); "
          f"{batch_size * seq / (med / 1e3):.0f} tokens/s "
          f"({positions / (med / 1e3):.0f} positions/s); model "
          f"{flops / 1e12:.2f} TFLOP a step, MFU {mfu:.4f} at the bf16 peak "
          f"{PEAK_BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; peak memory "
          f"{peak / 2**30:.2f} GiB; {card}")
    out = {"params": n, "batch": batch_size, "seq": seq,
           "positions": positions, "losses": losses, "aux": auxes,
           "step_ms": med, "step_ms_runs": ms,
           "tokens_per_s": batch_size * seq / (med / 1e3),
           "model_flops": flops, "mfu": mfu, "peak_bytes": peak,
           "launches": {"flash": counts[0], "ssd": counts[1]},
           "profile": prof, "probe": probe}
    state = holder[0]
    del holder, step, batches
    if cfg.modality:
        b = probe["batch_no_remat"]
        if b < 1:
            raise AssertionError(f"{cfg.name}: remat=False fits no batch")
        out["remat_peaks"] = {str(r): _grad_peak(cfg, state, data_fn(b), r)
                              for r in (True, False, "dots")}
        print(f"  forward + backward peak memory at batch {b} (what "
              f"remat=False fits): " + ", ".join(
                  f"remat={r} {v / 2**30:.2f} GiB"
                  for r, v in out["remat_peaks"].items()))
    del state
    _lm_free()
    return out


def _routers(params) -> list:
    """The MoE routers' leaves, stacked over each group's repeats."""
    return [unit["moe"]["router"] for group in params["groups"]
            for unit in group if "moe" in unit]


def _train_xcheck(arch, dev) -> dict:
    """``arch`` at full width cut to 2 layers, fp32, on 1 × 512 tokens
    (behind the prefix): step 0's loss, aux, total and gradient leaves and
    two ``make_train_step`` steps on the card against the same on the CPU
    from the same weights and batches; remat True, False and ``"dots"``
    against each other on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.transformer import init_transformer
    from repro_torch.optim import adamw
    from repro_torch.params import tree_leaves, tree_map, tree_unflatten
    from repro_torch.train import make_loss_fn, make_train_step

    cfg = dataclasses.replace(get_config(arch), **TRAIN_XCHECK)
    params = init_transformer(cfg, seed=0, device=dev)
    data = SyntheticLM(cfg.vocab_size, seed=1).batches(1, TRAIN_XCHECK_SEQ,
                                                        cfg)
    batches = [next(data) for _ in range(2)]

    def step0(p):
        live = [t.detach().clone().requires_grad_() for t in tree_leaves(p)]
        total, (loss, aux) = make_loss_fn(cfg)(tree_unflatten(p, live),
                                               batches[0])
        grads = torch.autograd.grad(total, live, materialize_grads=True)
        return torch.stack([total, loss, aux]).detach(), grads

    def two_steps(p, remat=True):
        opt = adamw(TRAIN_LR)
        state = _train_state(p, opt)
        step = make_train_step(cfg, opt, remat=remat)
        out = []
        for b in batches:
            state, m = step(state, b)
            out.append(torch.stack([m[k] for k in ("loss", "aux_loss",
                                                   "total_loss")]))
        return torch.stack(out)

    cpu = tree_map(lambda t: t.cpu(), params)
    t = time.perf_counter()
    want0, want_g = step0(cpu)
    want = two_steps(cpu)
    cpu_s = time.perf_counter() - t
    _zero_lm_counts()
    got0, got_g = step0(params)
    got = {r: two_steps(params, r).cpu() for r in (True, False, "dots")}
    _expect(f"{cfg.name} cross-check launches (flash, ssd)",
            _read_lm_counts(), (0, 0))
    tag = f"{cfg.name} 2 layers fp32 1×{TRAIN_XCHECK_SEQ}"
    err = _held(f"{tag} step 0 (total, loss, aux), card vs CPU",
                got0.cpu(), want0, TRAIN_RTOL)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        worst = max(worst, _held(f"  grad {i} {tuple(w.shape)}", g.cpu(), w,
                                 TRAIN_RTOL))
    for i in range(2):
        rel = ((got[True][i] - want[i]).abs()
               / want[i].abs().clamp_min(1e-30)).max().item()
        print(f"  {tag} step {i} (loss, aux, total) card "
              f"{got[True][i].tolist()} CPU {want[i].tolist()}: relative "
              f"|Δ| {rel:.2e}  {'ok' if rel <= TRAIN_RTOL else 'FAIL'}")
        if rel > TRAIN_RTOL:
            raise AssertionError(f"{tag} step {i} differs by {rel:.2e}")
    for r in (False, "dots"):
        rel = ((got[r] - got[True]).abs()
               / got[True].abs().clamp_min(1e-30)).max().item()
        print(f"  {tag} remat={r} against remat=True, both steps: relative "
              f"|Δ| {rel:.2e}  {'ok' if rel <= REMAT_RTOL else 'FAIL'}")
        if rel > REMAT_RTOL:
            raise AssertionError(f"{tag} remat={r} differs by {rel:.2e}")
    if cfg.moe:
        idx = [i for i, t in enumerate(tree_leaves(params))
               if any(t is r for r in _routers(params))]
        if not idx or not all(got_g[i].abs().max() > 0 for i in idx):
            raise AssertionError(f"{tag}: a router's gradient is zero")
        print(f"  {tag}: the router's gradient nonzero "
              f"(max|g| {max(got_g[i].abs().max().item() for i in idx):.3e})")
    print(f"  the CPU's side took {cpu_s:.1f} s")
    del params
    _lm_free()
    return {"step0_err": err, "grad_err": worst, "cpu_s": cpu_s}


def _guard_on_card(dev) -> None:
    """``make_train_step`` refuses a flash and a fused-SSD config; a
    grad-enabled call of either kernel's wrapper raises; neither kernel
    launched."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.ssd import ssd_chunked_fused
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    _zero_lm_counts()
    for arch, over in (("internvl2-1b", dict(attn_impl="flash")),
                       ("mamba2-1.3b", dict(ssm_impl="fused"))):
        cfg = dataclasses.replace(get_config(arch), **over)
        try:
            make_train_step(cfg, adamw(TRAIN_LR))
        except RuntimeError as e:
            print(f"  make_train_step({arch}, {over}) refused: "
                  f"{str(e)[:90]}…")
        else:
            raise AssertionError(f"make_train_step({arch}, {over}) did not "
                                 f"refuse a forward-only kernel")
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(1, 64, h, 64, generator=gen, device=dev,
                           dtype=torch.bfloat16).requires_grad_()
               for h in (14, 2, 2))
    x = torch.randn(1, 64, 4, 64, generator=gen, device=dev).requires_grad_()
    dt = torch.rand(1, 64, 4, generator=gen, device=dev)
    a = -torch.rand(4, generator=gen, device=dev)
    bm, cm = (torch.randn(1, 64, 32, generator=gen, device=dev)
              for _ in range(2))
    for name, call in (("flash_attention", lambda: flash_attention(q, k, v)),
                       ("ssd_chunked_fused", lambda: ssd_chunked_fused(
                           x, dt, a, bm, cm, chunk=64))):
        try:
            call()
        except RuntimeError as e:
            print(f"  grad-enabled {name} on the card refused: "
                  f"{str(e)[:60]}…")
        else:
            raise AssertionError(f"grad-enabled {name} did not raise")
    _expect("launches of the refused calls (flash, ssd)", _read_lm_counts(),
            (0, 0))


def lm_train(dev, card: str) -> dict:
    """Phase 27: LM training at full width and depth (InternVL2-1B behind
    its prefix, Granite-MoE-1B-A400M with the MoE aux loss), the fp32
    cross-checks against the CPU under deterministic algorithms, and the
    forward-only kernels' refusals on the card."""
    out = {arch: _train_cell(arch, dev, card) for arch in TRAIN_ARCHS}
    with _deterministic("phase 27 cross-checks"):
        out["xcheck"] = {arch: _train_xcheck(arch, dev)
                         for arch in TRAIN_ARCHS}
    _guard_on_card(dev)
    return out


# ---------------------------------------------------------------------------
# The sharded LM on a (data=1, model=1) mesh (phase 28)
# ---------------------------------------------------------------------------

SHARD_TRAIN_ARCH = "granite-moe-1b-a400m"
SHARD_TRAIN_BATCH = 4       # half phase 27's 8: the gathered weights' room
SHARD_TRAIN_STEPS = 3       # timed, after step 0 (the warm-up)
SHARD_RTOL = 1e-5           # step 0's loss against the unsharded step's
                            # and each gradient leaf's ‖Δ‖/‖ref‖


def _gather_calls(cfg, sharder) -> int:
    """``param_gather`` calls of one forward under ``sharder``: each
    leaf's gather at use, one call per mesh axis it drops, for the
    embedding, final norm, head and prefix projection once and each
    block's leaves at each use (the shared block at each of its uses)."""
    from repro_torch.models import blocks as B
    from repro_torch.sharding.specs import _axes_of
    specs = sharder.param_specs(cfg)

    def calls(tree):
        if isinstance(tree, dict):
            return sum(calls(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(calls(v) for v in tree)
        return len(_axes_of(tree.spec)) - len(_axes_of(tree.use))
    n = sum(calls(specs[k]) for k in ("embed", "final_norm", "head",
                                      "mm_proj") if k in specs)
    for g, gs in zip(B.layer_groups(cfg), specs["groups"]):
        for kind, sp in zip(g.unit, gs):
            n += g.repeats * calls(specs["shared_block"]
                                   if kind == "shared_attn" else sp)
    return n


def _sharded_scoring(dev, mesh, card: str) -> dict:
    """Zamba2-2.7B at full width, bf16 compute: ``forward(shard=
    ExplicitSharder)`` on phase 17's 2 × 2048 tokens under no_grad (the
    explicit paths decline at a model axis of 1, so the plain transitions
    run: all-to-alls and all-gathers over groups of one rank) beside the
    unsharded forward: 9 flash and 45 SSD launches in the sharded run,
    the logits equal (bitwise, or within 1e-5·max|ref| with the
    difference printed), the ledger equal to the schedule at N = 1."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.runtime.telemetry import collect_comm
    from repro_torch.sharding import ExplicitSharder, ShardingRules
    from repro_torch.sharding.specs import place_params
    cfg, params, _ = _lm_model("zamba2-2.7b", dev)
    batch = next(SyntheticLM(cfg.vocab_size, seed=0).batches(2, 2048))
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    targets = torch.as_tensor(batch["targets"], device=dev)
    sharder = ExplicitSharder(mesh, ShardingRules("neutron_tp"))
    shards = place_params(params, cfg, sharder)
    n_attn, n_mamba = _attn_layers(cfg), cfg.layer_kinds().count("mamba")
    with torch.no_grad(), _deterministic("phase 28 scoring"):
        want, _ = T.forward(params, cfg, tokens)
        _zero_lm_counts()
        with collect_comm() as ledger:
            got, _ = T.forward(shards, cfg, tokens, shard=sharder)
        counts = _read_lm_counts()
        _expect("sharded scoring launches (flash, ssd)", counts,
                (n_attn, n_mamba))
        diff = (got - want).abs().max().item()
        bitwise = torch.equal(got, want)
        print(f"  sharded scoring logits {tuple(got.shape)} against the "
              f"unsharded forward's: "
              + ("bitwise equal" if bitwise else
                 f"max|Δ| {diff:.3e} (max|ref| "
                 f"{want.abs().max().item():.3e})"))
        _held("sharded scoring logits vs unsharded", got, want, KERNEL_TOL,
              0.0)
        loss = T.lm_loss(got, targets).item()
        del got, want
    with torch.no_grad():
        led = ledger.as_dict()
        print(f"  ledger of the sharded scoring forward: {json.dumps(led)}")
        sched = {"all_to_all|model": 4 * n_attn + 3 * n_mamba,
                 "all_gather|model": 2 * n_mamba,
                 "param_gather": _gather_calls(cfg, sharder)}
        have = {k: sum(e["calls"] for key, e in led.items()
                       if key.startswith(k)) for k in sched}
        _expect("sharded scoring ledger calls (the schedule at N = 1: q, "
                "k, v and the output a layer; xh, dt and y, and B and C "
                "gathered, a mamba layer; the parameter gathers)", have,
                sched)
        if any(e["wire_bytes"] or e["mirrored_calls"] for e in led.values()):
            raise AssertionError("wire bytes or backward calls at N = 1 "
                                 "under no_grad")
        ms = {}
        for name, fn in (("unsharded", lambda: T.forward(params, cfg,
                                                          tokens)),
                         ("sharded", lambda: T.forward(
                             shards, cfg, tokens, shard=sharder))):
            runs = []
            for _ in range(LM_RUNS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()[0].sum().item()
                runs.append((time.perf_counter() - t) * 1e3)
            ms[name] = runs
        torch.cuda.reset_peak_memory_stats()
        prof = _profile(lambda: T.forward(shards, cfg, tokens,
                                          shard=sharder)[0].sum().item(),
                        "sharded scoring forward")
        peak = torch.cuda.max_memory_allocated()
    print(f"  scoring loss {loss:.6f}; forward ms unsharded "
          f"{statistics.median(ms['unsharded']):.2f} "
          f"({ms['unsharded']}), sharded "
          f"{statistics.median(ms['sharded']):.2f} ({ms['sharded']}); "
          f"peak memory {peak / 2**30:.2f} GiB; {card}")
    del params, shards
    _lm_free()
    return {"launches": {"flash": counts[0], "ssd": counts[1]},
            "bitwise": bitwise, "max_abs_diff": diff, "loss": loss,
            "ledger": led, "ms": ms, "profile": prof, "peak_bytes": peak}


def grads_held(name: str, got, want, rtol: float = SHARD_RTOL) -> float:
    """Hold every leaf of the gradient tree ``got`` to ``want``'s within
    ‖Δ‖ ≤ rtol·‖want‖ (‖Δ‖ ≤ rtol where ``want``'s leaf is zero); returns
    the largest ‖Δ‖/‖want‖."""
    from repro_torch.params import tree_leaves
    worst, at = 0.0, None
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want),
                                   strict=True)):
        d = (g.float() - w.float()).norm().item()
        n = w.float().norm().item()
        rel = d / n if n else d
        if rel >= worst:
            worst, at = rel, i
    ok = worst <= rtol
    print(f"  {name}: every gradient leaf, largest ‖Δ‖/‖ref‖ {worst:.2e} "
          f"(leaf {at})  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: gradient leaf {at} differs by "
                             f"{worst:.2e}")
    return worst


def _sharded_training(dev, mesh, card: str) -> dict:
    """Granite-MoE-1B-A400M at full width and depth, phase 27's
    configuration (naive attention, bf16 compute over fp32 parameters,
    4096 tokens), through ``sharded_setup(..., ShardingRules(
    "neutron_tp"))`` at batch ``SHARD_TRAIN_BATCH``: step 0 (under
    deterministic algorithms) against the unsharded step on the same batch
    within ``SHARD_RTOL``, and its gradients (each rank's shards reduced
    and gathered) leaf for leaf against the unsharded ones within the same
    relative bound, ``SHARD_TRAIN_STEPS`` timed steps, no kernel
    launch, one audited step (clean), one profiled step, peak memory."""
    import dataclasses

    from repro_torch.configs import get_config, get_shape
    from repro_torch.data import SyntheticLM
    from repro_torch.models.transformer import init_transformer
    from repro_torch.sharding import ShardingRules
    from repro_torch.sharding.specs import gather_params, place_params
    from repro_torch.train import (init_sharded_state, make_grad_fn,
                                   sharded_setup)
    cfg = get_config(SHARD_TRAIN_ARCH)
    shape = dataclasses.replace(get_shape("train_4k"),
                                global_batch=SHARD_TRAIN_BATCH)
    setup = sharded_setup(cfg, shape, mesh, ShardingRules("neutron_tp"),
                          lr=TRAIN_LR)
    params = init_transformer(cfg, seed=0, device=dev)
    data = SyntheticLM(cfg.vocab_size, seed=0).batches(
        SHARD_TRAIN_BATCH, shape.seq_len, cfg)
    batches = [next(data) for _ in range(SHARD_TRAIN_STEPS + 3)]
    _zero_lm_counts()
    sharder = setup["sharder"]
    with _deterministic("phase 28 step 0"):
        want_g, (_, want, _) = make_grad_fn(cfg)(params, batches[0])
        want = want.item()
        got_g = gather_params(make_grad_fn(cfg, sharder)(
            place_params(params, cfg, sharder), batches[0])[0], cfg, sharder)
        grad_rel = grads_held("step 0 gradients, sharded vs unsharded",
                              got_g, want_g)
        del got_g, want_g
        _lm_free()
        state = init_sharded_state(params, cfg, setup["optimizer"],
                                   sharder)
        del params
        _lm_free()
        torch.cuda.reset_peak_memory_stats()
        state, m = setup["train_step"](state, batches[0])
        got = m["loss"].item()
    rel = abs(got - want) / abs(want)
    print(f"  step 0 loss sharded {got:.7f}, unsharded {want:.7f}: relative "
          f"|Δ| {rel:.2e}  {'ok' if rel <= SHARD_RTOL else 'FAIL'}")
    if rel > SHARD_RTOL:
        raise AssertionError(f"sharded step 0 differs by {rel:.2e}")
    losses, ms = [got], []
    for b in batches[1:SHARD_TRAIN_STEPS + 1]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = setup["train_step"](state, b)
        losses.append(m["loss"].item())
        ms.append((time.perf_counter() - t) * 1e3)
    _expect("sharded training launches (flash, ssd)", _read_lm_counts(),
            (0, 0))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"sharded training losses {losses}")
    holder = [state]

    def one_step(b):
        holder[0], m = setup["train_step"](holder[0], b)
        return m["loss"].item()
    ledger, _ = _audited_step("phase 28 sharded train step", one_step,
                              batches[-2])
    prof = _profile(lambda: one_step(batches[-1]), "sharded train step")
    peak = torch.cuda.max_memory_allocated()
    # phase 31 holds its dry-run to these: the state's bytes and a
    # counted step's FLOPs
    state_bytes = _tensor_bytes([holder[0].params, holder[0].opt_state.mu,
                                 holder[0].opt_state.nu])
    counted = _counted(lambda: one_step(batches[1]))
    med = statistics.median(ms)
    print(f"  losses {[round(v, 4) for v in losses]}; step {med:.2f} ms "
          f"(median of {[round(v, 2) for v in ms]}); "
          f"{SHARD_TRAIN_BATCH * shape.seq_len / (med / 1e3):.0f} tokens/s; "
          f"peak memory {peak / 2**30:.2f} GiB; {card}")
    del state, holder
    _lm_free()
    return {"batch": SHARD_TRAIN_BATCH, "seq": shape.seq_len,
            "loss_step0": got,
            "loss_unsharded": want, "rel": rel, "grad_rel": grad_rel,
            "losses": losses,
            "step_ms": med, "step_ms_runs": ms, "peak_bytes": peak,
            "profile": prof, "ledger": ledger.as_dict(),
            "state_bytes": state_bytes, **counted}


def sharded_lm(dev, card: str) -> dict:
    """Phase 28: the LM's NeutronTP sharding on a (data=1, model=1) mesh
    of one NCCL rank — Zamba2's sharded scoring forward (both kernels),
    then Granite-MoE's sharded training step."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(model=1, data=1)
        out = {"scoring": _sharded_scoring(dev, mesh, card)}
        out["training"] = _sharded_training(dev, mesh, card)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 28 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Sharded LM serving on a (data=1, model=1) mesh (phase 29)
# ---------------------------------------------------------------------------

SEQ_MODES = (False, True, "model")     # ShardingRules.seq_shard_cache
# arch, overrides, prompt length, long_context settings
SERVE_XCHECKS = (
    ("gemma2-9b", dict(num_layers=4), 4608, (True, False)),
    ("deepseek-v2-lite-16b", dict(num_layers=3), 512, (False,)),
)


def greedy(prefill_fn, decode_fn, params, tokens, steps: int, *,
           max_len: int, sharder=None, ms=None, ledgers=None):
    """``tokens`` (B, S) prefilled and ``steps`` greedy decode steps
    through serving closures: (the prefill logits, the tokens (B, S +
    steps + 1), each step's logits (B, V)).  Under ``sharder`` each output
    is the rank's block of the token layout, gathered
    (``Sharder.unshard``) before its argmax.  ``ms``, a list, gets the
    prefill's and then each decode step's wall time; ``ledgers``, a list,
    each decode step's collective ledger."""
    from repro_torch.runtime.telemetry import collect_comm
    b, s = tokens.shape
    ms = [] if ms is None else ms

    def whole(x, n):
        return x if sharder is None else sharder.bound(b, n).unshard(x)

    def timed(fn):
        if tokens.is_cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        if tokens.is_cuda:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        return out
    logits, caches = timed(lambda: prefill_fn(params, tokens,
                                              max_len=max_len))
    logits = whole(logits, s)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    out, step_logits = [tokens, tok], []
    for _ in range(steps):
        with collect_comm() as led:
            last, caches = timed(lambda: decode_fn(params, tok, caches))
        if ledgers is not None:
            ledgers.append(led)
        last = whole(last, 1)[:, -1]
        tok = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
        out.append(tok)
        step_logits.append(last)
    return logits, torch.cat(out, dim=1).cpu().numpy(), step_logits


def held_serving(tag: str, got, want, rtol: float = KERNEL_TOL) -> float:
    """Hold one ``greedy`` run to another: identical tokens, the prefill
    and every step's logits within rtol·max|ref| (bitwise reported);
    returns the largest max|Δ|."""
    if not np.array_equal(got[1], want[1]):
        raise AssertionError(f"{tag}: greedy tokens differ: "
                             f"{got[1][:, -8:]} vs {want[1][:, -8:]}")
    pairs = [(got[0], want[0])] + list(zip(got[2], want[2]))
    errs = [(g - w).abs().max().item() for g, w in pairs]
    worst = max(e / w.abs().max().item() for e, (_, w) in zip(errs, pairs))
    ok = worst <= rtol
    print(f"  {tag}: tokens identical over {len(pairs) - 1} steps, logits "
          + ("bitwise equal" if not any(errs) else
             f"max|Δ| {max(errs):.3e} ({worst:.2e} of max|ref|)")
          + f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: logits differ by {worst:.3e} of "
                             f"max|ref|")
    return max(errs)


def _serving_twin(cfg, params, tokens, steps, max_len, dev):
    """The unsharded closures: prefill and decode medians, one decode step
    more profiled (the caches hold ``max_len`` + 1 positions)."""
    from repro_torch.serve import make_serve_fns
    prefill_fn, decode_fn = make_serve_fns(cfg)
    pre = []
    for _ in range(LM_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = prefill_fn(params, tokens, max_len=max_len + 1)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t) * 1e3)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    del logits
    dec = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        last, caches = decode_fn(params, tok, caches)
        tok = torch.argmax(last[:, -1], dim=-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        dec.append((time.perf_counter() - t) * 1e3)
    prof = _profile(lambda: decode_fn(params, tok, caches),
                    "unsharded decode step")
    return {"prefill_ms_runs": pre, "prefill_ms": statistics.median(pre),
            "decode_ms_runs": dec, "decode_ms": statistics.median(dec),
            "profile_decode": prof}


def _sharded_generate(dev, mesh, card: str) -> dict:
    """Zamba2-2.7B at full width and depth (flash, bf16 compute on fp32
    weights): 2 × 2048 prefilled and ``LM_STEPS`` greedy steps through
    ``make_serve_fns(cfg, ExplicitSharder(...))`` beside phase 16's
    unsharded ``generate``: identical tokens, prefill logits bitwise (else
    within 1e-5·max|ref|), 9 flash launches in the sharded prefill and
    none in its decode steps (counts zeroed just before each), no wire
    bytes; both paths' prefill and decode medians, one decode step of
    each profiled."""
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime.telemetry import collect_comm
    from repro_torch.serve import generate, make_serve_fns
    from repro_torch.sharding import ExplicitSharder, ShardingRules
    from repro_torch.sharding.specs import place_params
    cfg, params, _ = _lm_model("zamba2-2.7b", dev)
    prompt = next(SyntheticLM(cfg.vocab_size, seed=0).batches(2, 2048))[
        "tokens"]
    tokens = torch.as_tensor(prompt, device=dev)
    b, s = tokens.shape
    steps, max_len = LM_STEPS, s + LM_STEPS
    with torch.no_grad():
        res = generate(params, cfg, prompt, steps, device=dev)
        want_logits, want_tokens = res.prefill_logits, res.tokens
        del res
        sharder = ExplicitSharder(mesh, ShardingRules("neutron_tp"))
        shards = place_params(params, cfg, sharder)
        prefill_fn, decode_fn = make_serve_fns(cfg, sharder)
        _zero_lm_counts()
        with collect_comm() as pre_led:
            logits, caches = prefill_fn(shards, tokens, max_len=max_len)
        pre_counts, cases = _read_lm_counts(), _flash_case_counts()
        print(f"  sharded prefill {b} × {s}: launches flash {pre_counts[0]}"
              f" ({cases}), ssd {pre_counts[1]}")
        _expect("sharded prefill launches (flash, ssd)", pre_counts,
                (_attn_layers(cfg), 0))
        _expect("sharded prefill flash launches by case", cases,
                _lm_flash_cases(cfg))
        logits = sharder.bound(b, s).unshard(logits)
        bitwise = torch.equal(logits, want_logits)
        diff = _held("sharded prefill logits vs unsharded", logits,
                     want_logits, KERNEL_TOL, 0.0)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        del logits, want_logits
        out, dec_ms, led_step = [prompt, tok.cpu().numpy()], [], None
        _zero_lm_counts()
        with collect_comm() as dec_led:
            for i in range(steps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                with collect_comm() as one:
                    last, caches = decode_fn(shards, tok, caches)
                last = sharder.bound(b, 1).unshard(last)
                tok = torch.argmax(last[:, -1], dim=-1)[:, None].to(
                    torch.int32)
                torch.cuda.synchronize()
                dec_ms.append((time.perf_counter() - t) * 1e3)
                out.append(tok.cpu().numpy())
                led_step = led_step or one.as_dict()
        _expect(f"sharded decode launches over {steps} steps (flash, ssd)",
                _read_lm_counts(), (0, 0))
        # generate's tokens: the prompt, the prefill's token and the
        # first steps - 1 decode steps' (it does not sample the last)
        got_tokens = np.concatenate(out, axis=1)[:, :s + steps]
        if not np.array_equal(got_tokens, want_tokens):
            raise AssertionError(f"sharded serving tokens differ from "
                                 f"generate's: {got_tokens[:, s:]} vs "
                                 f"{want_tokens[:, s:]}")
        wire = pre_led.wire_bytes() + dec_led.wire_bytes()
        _expect("sharded serving wire bytes at N = 1", wire, 0)
        print(f"  sharded serving tokens identical to generate's over "
              f"{steps} steps; prefill logits "
              + ("bitwise equal" if bitwise else f"max|Δ| {diff:.3e}")
              + f"; one decode step's ledger calls "
              f"{ {k: e['calls'] for k, e in led_step.items()} }")
        pre_ms = []
        for _ in range(LM_RUNS):
            caches = None
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, caches = prefill_fn(shards, tokens, max_len=max_len)
            torch.cuda.synchronize()
            pre_ms.append((time.perf_counter() - t) * 1e3)
        del logits
        prof = _profile(lambda: decode_fn(shards, tok, caches),
                        "sharded decode step")
        caches = None
        twin = _serving_twin(cfg, params, tokens, steps, max_len, dev)
    pre, dec = statistics.median(pre_ms), statistics.median(dec_ms)
    print(f"  sharded prefill {pre:.2f} ms (median of {pre_ms}), unsharded "
          f"{twin['prefill_ms']:.2f} ({twin['prefill_ms_runs']}); sharded "
          f"decode {dec:.2f} ms a step (median of {steps}), unsharded "
          f"{twin['decode_ms']:.2f}; wire bytes a decode step 0; {card}")
    del params, shards
    _lm_free()
    return {"launches": {"flash": pre_counts[0], "ssd": pre_counts[1],
                         "flash_by_case": cases},
            "bitwise": bitwise, "max_abs_diff": diff,
            "prefill_ledger": pre_led.as_dict(), "decode_ledger": led_step,
            "prefill_ms": pre, "prefill_ms_runs": pre_ms,
            "decode_ms": dec, "decode_ms_runs": dec_ms,
            "profile_decode": prof, "unsharded": twin}


def _serving_xchecks(dev, mesh) -> dict:
    """fp32 at full width cut in depth (``SERVE_XCHECKS``): each config's
    greedy serving through ``make_serve_fns(cfg, ExplicitSharder(...))``
    under each ``seq_shard_cache`` layout against its unsharded twin, at
    each of its ``long_context`` settings, under deterministic
    algorithms: tokens identical, logits within 1e-5·max|ref|."""
    import dataclasses

    from repro_torch.data import SyntheticLM
    from repro_torch.serve import make_serve_fns
    from repro_torch.sharding import ExplicitSharder, ShardingRules
    from repro_torch.sharding.specs import place_params
    out = {}
    with torch.no_grad(), _deterministic("phase 29 cross-checks"):
        for arch, over, s, lcs in SERVE_XCHECKS:
            cfg, params, _ = _lm_model(arch, dev, **over)
            cfg = dataclasses.replace(cfg, dtype="float32")
            tokens = torch.as_tensor(next(SyntheticLM(
                cfg.vocab_size, seed=1).batches(1, s))["tokens"], device=dev)
            max_len = s + LM_XCHECK_STEPS
            for lc in lcs:
                want = greedy(*make_serve_fns(cfg, long_context=lc), params,
                              tokens, LM_XCHECK_STEPS, max_len=max_len)
                for mode in SEQ_MODES:
                    sharder = ExplicitSharder(mesh, ShardingRules(
                        seq_shard_cache=mode))
                    shards = place_params(params, cfg, sharder)
                    got = greedy(*make_serve_fns(cfg, sharder,
                                                 long_context=lc),
                                 shards, tokens, LM_XCHECK_STEPS,
                                 max_len=max_len, sharder=sharder)
                    tag = (f"{cfg.name} fp32 1×{s}"
                           f"{' long_context' if lc else ''} "
                           f"seq_shard_cache={mode!r}")
                    out[tag] = held_serving(tag, got, want)
                    del shards, got
                del want
            del params
            _lm_free()
    return out


def sharded_serving(dev, card: str) -> dict:
    """Phase 29: sharded LM serving on a (data=1, model=1) mesh of one
    NCCL rank — Zamba2-2.7B's sharded prefill and greedy decode beside
    ``generate``, then the fp32 cross-checks of the three cache
    layouts."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(model=1, data=1)
        out = {"zamba2": _sharded_generate(dev, mesh, card)}
        out["xchecks"] = _serving_xchecks(dev, mesh)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 29 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# The megatron strategy on a (data=1, model=1) mesh (phase 30)
# ---------------------------------------------------------------------------

def _tp_psum_calls(cfg, n: int) -> int:
    """``tp_psum`` calls of one megatron forward or decode step at model
    degree ``n`` (``runtime/telemetry.py``): the vocab-split embedding's
    lookup; each attention layer's out-projection (the shared block at
    each use) where the heads divide; each MLP's down projection where
    d_ff does; a MoE layer's combine where the experts divide and its
    shared experts' where their width does; a mamba2 layer's gated-norm
    sum where its heads divide and its out_proj where d_inner does."""
    def split(size):
        return int(size % n == 0)
    total = split(cfg.padded_vocab)
    for kind in cfg.layer_kinds():
        if kind == "mamba":
            total += split(cfg.ssm_heads) + split(cfg.d_inner)
        else:
            total += split(cfg.num_heads)
            if kind == "moe":
                total += split(cfg.num_experts) + (
                    split(cfg.moe_d_ff * cfg.num_shared_experts)
                    if cfg.num_shared_experts else 0)
            else:
                total += split(cfg.d_ff)
    return total


def _megatron_ledger(tag: str, led: dict, cfg) -> dict:
    """Hold a megatron forward's or decode step's ledger at N = 1: the
    row-parallel sums ``_tp_psum_calls``, no parameter gathered over the
    model axis, no wire byte; returns the calls by key."""
    calls = {k: e["calls"] for k, e in led.items()}
    _expect(f"{tag} tp_psum calls", sum(
        c for k, c in calls.items() if k.startswith("tp_psum|model")),
        _tp_psum_calls(cfg, 1))
    gathered = [k for k in calls if k.startswith("param_gather|model")]
    _expect(f"{tag} parameter gathers over the model axis", gathered, [])
    _expect(f"{tag} wire bytes at N = 1",
            sum(e["wire_bytes"] for e in led.values()), 0)
    return calls


def _megatron_scoring(dev, sharder, card: str) -> dict:
    """Zamba2-2.7B at full width, bf16 compute: ``forward(shard=
    Sharder(megatron))`` on phase 17's 2 × 2048 tokens under no_grad
    beside the unsharded forward: 9 flash and 45 SSD launches, logits
    bitwise (else within 1e-5·max|ref|, the difference printed), the
    ledger held (``_megatron_ledger``); both forwards' medians."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.runtime.telemetry import collect_comm
    from repro_torch.sharding.specs import place_params
    cfg, params, _ = _lm_model("zamba2-2.7b", dev)
    tokens = torch.as_tensor(next(SyntheticLM(cfg.vocab_size, seed=0)
                                  .batches(2, 2048))["tokens"], device=dev)
    shards = place_params(params, cfg, sharder)
    with torch.no_grad(), _deterministic("phase 30 scoring"):
        want, _ = T.forward(params, cfg, tokens)
        _zero_lm_counts()
        with collect_comm() as ledger:
            got, _ = T.forward(shards, cfg, tokens, shard=sharder)
        counts = _read_lm_counts()
        _expect("megatron scoring launches (flash, ssd)", counts,
                (_attn_layers(cfg), cfg.layer_kinds().count("mamba")))
        bitwise = torch.equal(got, want)
        diff = _held("megatron scoring logits vs unsharded", got, want,
                     KERNEL_TOL, 0.0)
        print(f"  megatron scoring logits {tuple(got.shape)}: "
              + ("bitwise equal" if bitwise else f"max|Δ| {diff:.3e}")
              + " to the unsharded forward's")
        del got, want
        calls = _megatron_ledger("megatron scoring", ledger.as_dict(), cfg)
        print(f"  ledger calls of the megatron scoring forward: {calls}")
        ms = {}
        for name, fn in (("unsharded", lambda: T.forward(params, cfg,
                                                          tokens)),
                         ("megatron", lambda: T.forward(
                             shards, cfg, tokens, shard=sharder))):
            runs = []
            for _ in range(LM_RUNS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()[0].sum().item()
                runs.append((time.perf_counter() - t) * 1e3)
            ms[name] = runs
    print(f"  forward ms unsharded {statistics.median(ms['unsharded']):.2f} "
          f"({ms['unsharded']}), megatron "
          f"{statistics.median(ms['megatron']):.2f} ({ms['megatron']}); "
          f"{card}")
    del params, shards
    _lm_free()
    return {"launches": {"flash": counts[0], "ssd": counts[1]},
            "bitwise": bitwise, "max_abs_diff": diff, "ledger_calls": calls,
            "ms": ms}


def _megatron_serving(dev, sharder, card: str) -> dict:
    """Zamba2-2.7B at full width (flash, bf16 compute): 2 × 2048 prefilled
    and ``LM_STEPS`` greedy steps through ``make_serve_fns(cfg,
    Sharder(megatron))`` beside ``generate``: identical tokens, prefill
    logits bitwise (else within 1e-5·max|ref|), 9 flash launches in the
    prefill and none in its decode steps (counts zeroed just before each),
    a decode step's ledger held (``_megatron_ledger``); the prefill and
    decode medians, one decode step profiled."""
    from repro_torch.data import SyntheticLM
    from repro_torch.serve import generate, make_serve_fns
    from repro_torch.sharding.specs import place_params
    cfg, params, _ = _lm_model("zamba2-2.7b", dev)
    prompt = next(SyntheticLM(cfg.vocab_size, seed=0).batches(2, 2048))[
        "tokens"]
    tokens = torch.as_tensor(prompt, device=dev)
    b, s = tokens.shape
    steps, max_len = LM_STEPS, s + LM_STEPS
    with torch.no_grad():
        res = generate(params, cfg, prompt, steps, device=dev)
        want_logits, want_tokens = res.prefill_logits, res.tokens
        del res
        shards = place_params(params, cfg, sharder)
        prefill_fn, decode_fn = make_serve_fns(cfg, sharder)
        _zero_lm_counts()
        logits, caches = prefill_fn(shards, tokens, max_len=max_len)
        pre_counts = _read_lm_counts()
        _expect("megatron prefill launches (flash, ssd)", pre_counts,
                (_attn_layers(cfg), 0))
        bitwise = torch.equal(logits, want_logits)
        diff = _held("megatron prefill logits vs unsharded", logits,
                     want_logits, KERNEL_TOL, 0.0)
        del want_logits
        ms, ledgers = [], []
        _zero_lm_counts()
        got = greedy(lambda *a, **k: (logits, caches), decode_fn, shards,
                     tokens, steps, max_len=max_len, sharder=sharder,
                     ms=ms, ledgers=ledgers)
        _expect(f"megatron decode launches over {steps} steps (flash, ssd)",
                _read_lm_counts(), (0, 0))
        got_tokens = got[1][:, :s + steps]
        if not np.array_equal(got_tokens, want_tokens):
            raise AssertionError(f"megatron serving tokens differ from "
                                 f"generate's: {got_tokens[:, s:]} vs "
                                 f"{want_tokens[:, s:]}")
        calls = _megatron_ledger("megatron decode step",
                                 ledgers[0].as_dict(), cfg)
        if any(led.as_dict() != ledgers[0].as_dict() for led in ledgers):
            raise AssertionError("megatron decode steps' ledgers differ")
        print(f"  megatron serving tokens identical to generate's over "
              f"{steps} steps; prefill logits "
              + ("bitwise equal" if bitwise else f"max|Δ| {diff:.3e}")
              + f"; one decode step's ledger calls {calls}")
        pre_ms = []
        for _ in range(LM_RUNS):
            caches = None
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, caches = prefill_fn(shards, tokens, max_len=max_len + 1)
            torch.cuda.synchronize()
            pre_ms.append((time.perf_counter() - t) * 1e3)
        tok = torch.as_tensor(got_tokens[:, -1:], device=dev)
        prof = _profile(lambda: decode_fn(shards, tok, caches),
                        "megatron decode step")
        # phase 31 holds its dry-run to these: the shards' and caches'
        # bytes and a counted decode step's FLOPs
        state_bytes = _tensor_bytes([shards, caches])
        counted = _counted(lambda: decode_fn(shards, tok, caches))
        caches = None
    pre, dec = statistics.median(pre_ms), statistics.median(ms[1:])
    print(f"  megatron prefill {pre:.2f} ms (median of {pre_ms}); decode "
          f"{dec:.2f} ms a step (median of {steps}); {card}")
    del params, shards
    _lm_free()
    return {"launches": {"flash": pre_counts[0], "ssd": pre_counts[1]},
            "bitwise": bitwise, "max_abs_diff": diff,
            "decode_ledger_calls": calls,
            "decode_ledger": ledgers[0].as_dict(),
            "decode_batch": b, "decode_cache_len": max_len + 1,
            "state_bytes": state_bytes, **counted, "prefill_ms": pre,
            "prefill_ms_runs": pre_ms, "decode_ms": dec,
            "decode_ms_runs": ms[1:], "profile_decode": prof}


def _megatron_training(dev, mesh, card: str) -> dict:
    """Granite-MoE-1B-A400M at full width and depth, phase 28's
    configuration, through ``sharded_setup(..., ShardingRules(
    "megatron"))`` at batch ``SHARD_TRAIN_BATCH``: step 0 under
    deterministic algorithms against the unsharded step on the same batch
    (the loss bitwise, else within ``SHARD_RTOL``), its gradients (the
    shards reduced and gathered) leaf for leaf within ``SHARD_RTOL``
    (``grads_held``), the step's ledger held (the forward's row-parallel
    sums and their mirrors), two timed steps, no kernel launch."""
    import dataclasses

    from repro_torch.configs import get_config, get_shape
    from repro_torch.data import SyntheticLM
    from repro_torch.models.transformer import init_transformer
    from repro_torch.runtime.telemetry import collect_comm
    from repro_torch.sharding import ShardingRules
    from repro_torch.sharding.specs import gather_params, place_params
    from repro_torch.train import (init_sharded_state, make_grad_fn,
                                   sharded_setup)
    cfg = get_config(SHARD_TRAIN_ARCH)
    shape = dataclasses.replace(get_shape("train_4k"),
                                global_batch=SHARD_TRAIN_BATCH)
    setup = sharded_setup(cfg, shape, mesh, ShardingRules("megatron"),
                          lr=TRAIN_LR)
    sharder = setup["sharder"]
    params = init_transformer(cfg, seed=0, device=dev)
    data = SyntheticLM(cfg.vocab_size, seed=0).batches(
        SHARD_TRAIN_BATCH, shape.seq_len, cfg)
    batches = [next(data) for _ in range(3)]
    _zero_lm_counts()
    with _deterministic("phase 30 step 0"):
        want_g, (_, want, _) = make_grad_fn(cfg)(params, batches[0])
        want = want.item()
        got_g = gather_params(make_grad_fn(cfg, sharder)(
            place_params(params, cfg, sharder), batches[0])[0], cfg, sharder)
        grad_rel = grads_held("megatron step 0 gradients vs unsharded",
                              got_g, want_g)
        del got_g, want_g
        _lm_free()
        state = init_sharded_state(params, cfg, setup["optimizer"],
                                   sharder)
        del params
        _lm_free()
        with collect_comm() as ledger:
            state, m = setup["train_step"](state, batches[0])
        got = m["loss"].item()
    print(f"  megatron step 0 loss {got:.7f}, unsharded {want:.7f}: "
          + ("bitwise equal" if got == want else
             f"relative |Δ| {abs(got - want) / abs(want):.2e}"))
    if abs(got - want) > SHARD_RTOL * abs(want):
        raise AssertionError(f"megatron step 0 differs: {got} vs {want}")
    led = ledger.as_dict()
    tp = led.get("tp_psum|model|bfloat16", {})
    _expect("megatron step's tp_psum calls (forward, backward)",
            (tp.get("calls"), tp.get("mirrored_calls")),
            (_tp_psum_calls(cfg, 1) - 1, _tp_psum_calls(cfg, 1) - 1))
    _expect("megatron step's fp32 tp_psum calls (the embedding's)",
            led.get("tp_psum|model|float32", {}).get("calls"), 1)
    losses, ms = [got], []
    for b in batches[1:]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = setup["train_step"](state, b)
        losses.append(m["loss"].item())
        ms.append((time.perf_counter() - t) * 1e3)
    _expect("megatron training launches (flash, ssd)", _read_lm_counts(),
            (0, 0))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"megatron training losses {losses}")
    med = statistics.median(ms)
    print(f"  losses {[round(v, 4) for v in losses]}; step {med:.2f} ms "
          f"({[round(v, 2) for v in ms]}); {card}")
    del state
    _lm_free()
    return {"batch": SHARD_TRAIN_BATCH, "loss_step0": got,
            "loss_unsharded": want, "bitwise": got == want,
            "grad_rel": grad_rel, "losses": losses, "step_ms": med,
            "step_ms_runs": ms, "ledger": led}


def megatron(dev, card: str) -> dict:
    """Phase 30: the megatron strategy on a (data=1, model=1) mesh of one
    NCCL rank — Zamba2-2.7B's scoring and serving (flash, SSD) under
    ``Sharder(megatron)``, then Granite-MoE's sharded training step."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import Sharder, ShardingRules
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(model=1, data=1)
        sharder = Sharder(mesh, ShardingRules("megatron"))
        out = {"scoring": _megatron_scoring(dev, sharder, card),
               "serving": _megatron_serving(dev, sharder, card),
               "training": _megatron_training(dev, mesh, card)}
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 30 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# The dry-run against phases 28 and 30 (phase 31)
# ---------------------------------------------------------------------------

def _tensor_bytes(tree) -> int:
    """The bytes of every tensor in ``tree`` (dicts, lists, tuples,
    dataclasses such as the decode caches)."""
    import dataclasses
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(_tensor_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


def _counted(fn) -> dict:
    """One more call of ``fn`` under ``FlopCounterMode``: its FLOPs, the
    bytes allocated on the card before it and its peak."""
    from torch.utils.flop_counter import FlopCounterMode
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        fn()
    torch.cuda.synchronize()
    return {"flops": float(fc.get_total_flops()), "resident_bytes": resident,
            "step_peak_bytes": torch.cuda.max_memory_allocated()}


DRYRUN_DECODE_ARCH = "zamba2-2.7b"   # phase 30's serving config

# the child that runs one dry-run: no card (CUDA_VISIBLE_DEVICES empty),
# the record as JSON
DRYRUN_CHILD = """
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
spec = json.loads(sys.argv[1])
cfg = dataclasses.replace(get_config(spec["arch"]), **spec["over"])
rec = dryrun.run_combo(cfg, InputShape(*spec["shape"]),
                       mesh_shape=spec["mesh"], strategy=spec["strategy"],
                       **spec.get("knobs", {}))
open(sys.argv[2], "w").write(json.dumps(rec))
"""


def _dryrun_children(specs: dict, out_dir: Path) -> dict:
    """Each spec's dry-run in a child process of its own, all at once:
    name → record."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CHILD, json.dumps(spec),
         str(out_dir / f"{name}.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, spec in specs.items()}
    recs = {}
    for name, p in procs.items():
        _, err = p.communicate(timeout=300)
        if p.returncode != 0:
            raise AssertionError(f"dry-run {name} failed: {err[-3000:]}")
        recs[name] = json.loads((out_dir / f"{name}.json").read_text())
    return recs


def _hold_dryrun(tag: str, rec: dict, card_ledger: dict, state_bytes: int,
                 flops: float) -> None:
    """The dry-run's ledger equal to the card's, entry for entry (calls
    and bytes by (op, axis, dtype)); its argument bytes the state's bytes
    on the card; its FLOPs the counted step's."""
    got = rec["ledger"]
    if set(got) != set(card_ledger):
        raise AssertionError(f"{tag} ledger keys: dry-run {sorted(got)}, "
                             f"card {sorted(card_ledger)}")
    for key, entry in card_ledger.items():
        if got[key] != entry:
            raise AssertionError(f"{tag} ledger {key}: dry-run {got[key]}, "
                                 f"card {entry}")
    _expect(f"{tag} argument bytes (dry-run) = state bytes on the card",
            rec["memory"]["argument_bytes"], state_bytes)
    _expect(f"{tag} FLOPs (dry-run) = the counted step's on the card",
            rec["cost"]["flops"], flops)
    print(f"  {tag}: ledger equal ({len(got)} entries, "
          f"{sum(e['calls'] for e in got.values()):.0f} calls), argument "
          f"bytes {state_bytes}, FLOPs {flops:.6e}")


def dryrun_check(shard_info: dict, megatron_info: dict, card: str) -> dict:
    """Phase 31: ``launch/dryrun.py`` on mesh (data 1, model 1), in child
    processes (this one holds an NCCL group; the dry-run opens torch's
    fake backend and touches no card), for two cells phases 28 and 30
    ran: Granite-MoE-1B-A400M's ``sharded_setup`` step at batch 4
    (neutron_tp) and Zamba2-2.7B's megatron decode step (batch 2, phase
    30's caches; a decode step runs neither kernel, so the dry-run takes
    the config with the default impls).  Held: the ledger equal entry for
    entry, the argument bytes the bytes of the state on the card
    (parameters and AdamW moments; parameters and caches), the FLOPs
    those ``FlopCounterMode`` counted in one more real step.  Recorded:
    the predicted peak and temporary bytes beside the card's, the H100
    roofline terms beside the measured step time."""
    t0 = time.perf_counter()
    tr, sv = shard_info["training"], megatron_info["serving"]
    mesh = {"model": 1, "data": 1}
    specs = {
        "granite_train": dict(
            arch=SHARD_TRAIN_ARCH, over={}, mesh=mesh, strategy="neutron_tp",
            shape=["train_4k", tr["seq"], tr["batch"], "train"]),
        "zamba2_megatron_decode": dict(
            arch=DRYRUN_DECODE_ARCH, over={"attn_impl": "naive",
                                           "ssm_impl": "jnp"},
            mesh=mesh, strategy="megatron",
            shape=["decode_32k", sv["decode_cache_len"], sv["decode_batch"],
                   "decode"])}
    recs = _dryrun_children(specs, ROOT / "build" / "chip_smoke" / "dryrun")
    out = {}
    for name, card_ledger, state, flops, step_ms, peak, resident in (
            ("granite_train", tr["ledger"], tr["state_bytes"], tr["flops"],
             tr["step_ms"], tr["step_peak_bytes"], tr["resident_bytes"]),
            ("zamba2_megatron_decode", sv["decode_ledger"], sv["state_bytes"],
             sv["flops"], sv["decode_ms"], sv["step_peak_bytes"],
             sv["resident_bytes"])):
        rec = recs[name]
        _hold_dryrun(name, rec, card_ledger, state, flops)
        r, mem = rec["roofline"], rec["memory"]
        bound_ms = 1e3 * max(r["compute_s"], r["memory_s"],
                             r["collective_s"])
        print(f"  {name}: predicted peak {mem['peak_bytes'] / 2**30:.2f} "
              f"GiB (temporary {mem['temp_bytes'] / 2**30:.2f}), card peak "
              f"{peak / 2**30:.2f} GiB ({(peak - resident) / 2**30:.2f} "
              f"above the {resident / 2**30:.2f} resident before the step); "
              f"H100 roofline compute {r['compute_s'] * 1e3:.2f} ms, memory "
              f"{r['memory_s'] * 1e3:.2f} ms, collective "
              f"{r['collective_s'] * 1e3:.2f} ms ({r['dominant']}) beside "
              f"the measured {step_ms:.2f} ms; trace "
              f"{rec['compile_seconds']:.1f} s; {card}")
        out[name] = {"argument_bytes": mem["argument_bytes"],
                     "predicted_peak_bytes": mem["peak_bytes"],
                     "predicted_temp_bytes": mem["temp_bytes"],
                     "card_peak_bytes": peak, "card_resident_bytes": resident,
                     "flops": rec["cost"]["flops"],
                     "bytes_accessed": rec["cost"]["bytes accessed"],
                     "roofline": {k: r[k] for k in (
                         "compute_s", "memory_s", "collective_s",
                         "dominant")},
                     "bound_ms": bound_ms, "measured_ms": step_ms,
                     "trace_s": rec["compile_seconds"]}
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 31 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# The single-device trainer, R-GCN, checkpoints, the example (phase 20)
# ---------------------------------------------------------------------------

SINGLE_EPOCHS = 13
SINGLE_RUN = dict(lr=1e-2, weight_decay=5e-4, seed=0, log_every=1)
# the environment a launcher such as torchrun sets, and the env contract of
# repro_torch.runtime.distributed: a child must not take this run for one
# of its ranks
LAUNCHER_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
                "PROCESS_ID", "DIST_INIT_TIMEOUT")


def _single_cfg(data, model: str, decoupled: bool):
    from repro_torch.gnn import models as M
    return M.GNNConfig(model=model, in_dim=data.features.shape[1],
                       hidden_dim=128, num_classes=data.num_classes,
                       num_layers=2, decoupled=decoupled,
                       num_edge_types=data.num_edge_types)


def _profile_second_epoch(run, label: str) -> dict:
    """Device busy and the top kernels of one epoch: ``run(callback)``
    trains two epochs and logs both; the profiler opens at epoch 1's log
    and closes at epoch 2's, so its window is one step and its metrics."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = []

    def callback(log):
        torch.cuda.synchronize()
        if log.epoch == 1:
            prof.start()
            marks.append(time.perf_counter())
        else:
            marks.append(time.perf_counter())
            prof.stop()

    run(callback)
    return _profile_summary(prof, (marks[1] - marks[0]) * 1e3, label)


def _held_accuracy(name: str, got: float, want: float, n: int) -> None:
    """Hold an accuracy over ``n`` vertices to ``PATH_RTOL`` relative plus
    one vertex: a vertex whose two top logits lie within fp32 rounding of
    each other may take another argmax under the card's order of sums
    than under the CPU's, which moves the accuracy by 1/n."""
    err = abs(got - want)
    ok = err <= PATH_RTOL * abs(want) + 1.0 / n + 1e-12
    print(f"  {name:<44} |Δ|={err:.3e} ({err * n:.0f} of {n} vertices)  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {got} against {want}")


def _single_run(data, cfg, dev, label: str):
    """``train_full_graph`` on the card for 13 epochs, logging each: finite
    and falling loss, no SpMM launch (the trainer aggregates by segment
    sums), the median epoch over epochs 4–13 and the peak memory; epoch
    1's loss and accuracies and epoch 2's loss within ``PATH_RTOL`` of the
    same two epochs on the CPU from the same weights (``init_params`` of
    the seed draws on the host; an accuracy within one vertex more,
    :func:`_held_accuracy`); one epoch profiled.  Returns (trained
    params, info)."""
    from repro_torch.gnn import train as TR
    from repro_torch.kernels.spmm import spmm_csr

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spmm_csr.launches = 0
    params, logs = TR.train_full_graph(data, cfg, epochs=SINGLE_EPOCHS,
                                       device=dev, **SINGLE_RUN)
    launches = spmm_csr.launches
    peak = torch.cuda.max_memory_allocated()
    for lg in logs:
        print(f"  epoch {lg.epoch:2d} loss {lg.loss:.6f}  train "
              f"{lg.train_acc:.4f} val {lg.val_acc:.4f} test "
              f"{lg.test_acc:.4f}  {lg.seconds * 1e3:.2f} ms")
    losses = [lg.loss for lg in logs]
    median_ms = statistics.median(lg.seconds for lg in logs[3:]) * 1e3
    print(f"  {label}: median epoch {median_ms:.2f} ms over epochs 4–"
          f"{SINGLE_EPOCHS}; peak memory {peak / 2**20:.1f} MiB; spmm_csr "
          f"launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses[0]} → "
                             f"{losses[-1]}")
    if launches:
        raise AssertionError(f"{label}: {launches} SpMM launches; the "
                             f"single-device trainer aggregates by segment "
                             f"sums")
    _, cpu_logs = TR.train_full_graph(data, cfg, epochs=2, device="cpu",
                                      **SINGLE_RUN)
    for got, want in zip(logs[:2], cpu_logs):
        _held(f"{label} epoch {got.epoch} loss, card vs CPU",
              torch.tensor(got.loss), torch.tensor(want.loss), PATH_RTOL,
              0.0)
    masks = {"train_acc": data.train_mask, "val_acc": data.val_mask,
             "test_acc": data.test_mask}
    for f, m in masks.items():
        _held_accuracy(f"{label} epoch 1 {f}, card vs CPU",
                       getattr(logs[0], f), getattr(cpu_logs[0], f),
                       int(m.sum()))
    profile = _profile_second_epoch(
        lambda cb: TR.train_full_graph(data, cfg, epochs=2, device=dev,
                                       callback=cb, **SINGLE_RUN),
        f"{label} epoch")
    return params, {"epoch_ms": median_ms, "peak_bytes": peak,
                    "launches": launches, "losses": losses,
                    "test_acc": logs[-1].test_acc, "profile": profile}


def _checkpoint_on_card(data, cfg, params, dev) -> dict:
    """Save the trained parameters, restore them into a template on the
    card: every leaf back on the card and bitwise equal, and the test
    accuracy (under deterministic algorithms) unchanged within 1e-6."""
    from repro_torch import checkpoint
    from repro_torch.gnn import layers as L
    from repro_torch.gnn import models as M
    from repro_torch.params import tree_leaves, tree_map

    g = L.edge_list_dev(data.graph, dev)
    x = torch.from_numpy(data.features).to(dev)
    labels = torch.from_numpy(data.labels).to(dev)
    mask = torch.from_numpy(data.test_mask.astype(np.float32)).to(dev)

    def test_acc(p):
        with torch.no_grad(), _deterministic("checkpoint test accuracy"):
            return M.accuracy(M.forward(p, cfg, g, x), labels, mask).item()

    path = str(ROOT / "build" / "chip_smoke" / "gcn_single")
    before = test_acc(params)
    checkpoint.save(path, params, metadata={"model": cfg.model,
                                            "test_acc": before})
    restored = checkpoint.restore(path, tree_map(torch.zeros_like, params))
    for a, b in zip(tree_leaves(restored), tree_leaves(params)):
        if a.device != b.device or not torch.equal(a, b):
            raise AssertionError(f"restored leaf {tuple(a.shape)} on "
                                 f"{a.device} differs from the saved one")
    after = test_acc(restored)
    print(f"  checkpoint {path}.npz: {len(tree_leaves(params))} leaves "
          f"restored on {dev}, bitwise equal; test accuracy {before:.6f} "
          f"→ {after:.6f}")
    if abs(after - before) >= 1e-6:
        raise AssertionError(f"test accuracy {after} after the round "
                             f"trip, {before} before")
    return {"test_acc": before, "restored_test_acc": after}


def _rgcn_tp(data, dev) -> dict:
    """R-GCN decoupled-pipelined TP on a blocksparse bundle (bs=128, 4
    chunks) over the 1-rank NCCL group: 16 SpMM launches a step, step-0
    held against the single-device decoupled forward on the bundle."""
    import dataclasses
    from repro_torch import optim
    from repro_torch.core import decouple as D
    from repro_torch.gnn import models as M
    from repro_torch.runtime import TPMesh

    bundle = D.prepare_bundle(data, n_workers=1, n_chunks=4,
                              agg="blocksparse", agg_block_size=128,
                              device=dev)
    cfg = dataclasses.replace(
        D.padded_gnn_config(data, bundle, model="rgcn", hidden_dim=128,
                            num_layers=2),
        num_edge_types=data.num_edge_types)
    mesh = TPMesh()
    params0 = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = optim.adamw(1e-2, weight_decay=5e-4)
    step, evaluate = D.make_tp_train_fns(cfg, bundle, mesh, opt,
                                         mode="decoupled_pipelined")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    name = "rgcn decoupled_pipelined"
    params, state, losses, launches, median_ms = _drive(
        name, step, evaluate, params0, opt, 16,
        "2 rounds × 4 chunks × forward and backward")
    peak = torch.cuda.max_memory_allocated()
    print(f"  {name}: peak memory {peak / 2**20:.1f} MiB")
    profile = _profile(lambda: step(params, state), f"{name} step")
    mask = bundle.train_mask
    _hold_same(name, D.make_tp_value_and_grad(
        cfg, bundle, mesh, mode="decoupled_pipelined")(params0, mask),
        [("pipelined vs single-device",
          _single_device_vg(M.decoupled_forward, cfg, bundle)(params0,
                                                              mask))],
        losses[0])
    return {**_path_info(launches, median_ms, profile, None, losses),
            "peak_bytes": peak}


def _run_example() -> dict:
    """``examples/train_gcn_full_graph_torch.py --epochs 20`` in a process
    of its own on the card (its own 1-rank NCCL group): exit code 0 and
    its checkpoint line."""
    ckpt = ROOT / "build" / "chip_smoke" / "example_gcn"
    cmd = [sys.executable,
           str(ROOT / "examples" / "train_gcn_full_graph_torch.py"),
           "--epochs", "20", "--ckpt", str(ckpt)]
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    env["PYTHONPATH"] = str(ROOT / "src")
    t = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    seconds = time.perf_counter() - t
    for line in res.stdout.splitlines():
        print(f"    | {line}")
    lines = res.stdout.splitlines()
    if res.returncode != 0 or not lines or lines[-1] != (
            f"checkpoint round-trip OK → {ckpt}.npz"):
        print(res.stderr[-4000:])
        raise AssertionError(f"the example exited {res.returncode}")
    print(f"  example exited 0 in {seconds:.1f} s")
    return {"seconds": seconds, "last_lines": lines[-3:]}


def single(dev) -> dict:
    """Phase 20: the single-device trainer (``gnn/train.py``) on
    reddit_like for GCN, SAGE, GIN and GAT, coupled and decoupled; a
    checkpoint of the trained decoupled GCN round-tripped on the card;
    R-GCN coupled and decoupled on a heterogeneous SBM of the same size,
    and its decoupled-pipelined TP step; the training example."""
    import torch.distributed as dist
    from repro_torch.graph.synthetic import heterogeneous_sbm, reddit_like

    out, trained = {}, None
    data = reddit_like(scale=1.0, seed=0)
    print(f"  graph n={data.graph.n} E={data.graph.e} features="
          f"{data.features.shape[1]} classes={data.num_classes}")
    for model in ("gcn", "sage", "gin", "gat"):
        for decoupled in (False, True):
            label = f"{model} {'decoupled' if decoupled else 'coupled'}"
            print(f"  -- {label}")
            params, out[label] = _single_run(
                data, _single_cfg(data, model, decoupled), dev, label)
            if model == "gcn" and decoupled:
                trained = params
    out["checkpoint"] = _checkpoint_on_card(
        data, _single_cfg(data, "gcn", True), trained, dev)
    del data, trained, params
    torch.cuda.empty_cache()

    data = heterogeneous_sbm(n=23000, num_classes=41, num_edge_types=4,
                             feat_dim=602, avg_degree=64, seed=0)
    print(f"  heterogeneous graph n={data.graph.n} E={data.graph.e} "
          f"relations={data.num_edge_types}")
    for decoupled in (False, True):
        label = f"rgcn {'decoupled' if decoupled else 'coupled'}"
        print(f"  -- {label}")
        _, out[label] = _single_run(
            data, _single_cfg(data, "rgcn", decoupled), dev, label)
    print("  -- rgcn decoupled-pipelined TP")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        out["rgcn tp"] = _rgcn_tp(data, dev)
    finally:
        dist.destroy_process_group()
    del data
    torch.cuda.empty_cache()
    print("  -- examples/train_gcn_full_graph_torch.py --epochs 20")
    out["example"] = _run_example()
    return out


# ---------------------------------------------------------------------------
# Multihost: per-rank placement and the launcher (phase 21)
# ---------------------------------------------------------------------------

MULTIHOST_RTOL = 1e-5     # the launcher's first loss against this process's
MULTIHOST_ARGS = ["--n", "23000", "--feat-dim", "602", "--classes", "41",
                  "--hidden", "128", "--layers", "2", "--chunks", "4",
                  "--epochs", "5"]
MULTIHOST_RUNS = {"gcn decoupled_pipelined": [],
                  "gcn dp": ["--mode", "dp"],
                  "gat constraint": ["--model", "gat", "--backend",
                                     "constraint"]}


def _placed(dev, card) -> dict:
    """Phase 21(a): phase 6's bundle placed on the 1-rank mesh
    (``prepare_bundle(mesh=...)``), trained 3 + 5 steps; step 0 against
    the unplaced bundle's under deterministic algorithms."""
    from repro_torch import optim
    from repro_torch.core import decouple as D
    from repro_torch.gnn import dp_baseline as DP
    from repro_torch.gnn import models as M
    from repro_torch.graph.synthetic import reddit_like
    from repro_torch.runtime import TPMesh
    from repro_torch.runtime.telemetry import collect_comm

    data, mesh = reddit_like(scale=1.0, seed=0), TPMesh()
    t0 = time.perf_counter()
    kw = dict(n_chunks=4, agg="blocksparse", agg_block_size=128, device=dev)
    whole = D.prepare_bundle(data, n_workers=1, **kw)
    placed = D.prepare_bundle(data, mesh=mesh, **kw)
    torch.cuda.synchronize()
    sizes = D.node_array_bytes(placed), D.node_array_bytes(whole)
    print(f"  placed bundle block {placed.block}: node arrays "
          f"{sizes[0]} bytes resident against {sizes[1]} unplaced (equal at "
          f"N=1; 1/N of them at N ranks); both prepared in "
          f"{time.perf_counter() - t0:.1f} s")
    if sizes[0] != sizes[1] or placed.block != (0, 1):
        raise AssertionError(f"placed bundle at N=1: {sizes}, "
                             f"{placed.block}")
    # the DP bundle placed slab by slab through the staging prefetcher,
    # from a host bundle: bitwise the direct placement, one h2d entry a slab
    host = DP.prepare_dp_bundle(data, k=1, device="cpu")
    with collect_comm() as led:
        streamed = DP.place_dp_bundle_streamed(host, mesh, n_slabs=4,
                                               device=dev)
    direct = DP.place_dp_bundle(host, mesh, device=dev)
    h2d = led.as_dict()
    slabs = sum(e["calls"] for k, e in h2d.items()
                if k.startswith("h2d|dp_rows|"))
    if slabs != 4 * len(D.NODE_ARRAYS) or not all(
            torch.equal(getattr(streamed, f), getattr(direct, f))
            for f in D.NODE_ARRAYS):
        raise AssertionError(f"streamed DP placement: {h2d}")
    print(f"  DP bundle placed slab by slab: {slabs:.0f} h2d entries of "
          f"{D.node_array_bytes(streamed)} bytes, bitwise the direct "
          f"placement  ok")
    del host, streamed, direct
    cfg = D.padded_gnn_config(data, placed, hidden_dim=128, num_layers=2)
    params0 = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    runs = {}
    # the unplaced bundle in the same phase: the host's pace changes
    # over the script, so only this pair compares
    for label, bundle in (("placed", placed), ("unplaced", whole)):
        opt = optim.adamw(1e-2, weight_decay=5e-4)
        step, evaluate = D.make_tp_train_fns(cfg, bundle, mesh, opt,
                                             mode="decoupled_pipelined")
        runs[label] = _drive(
            f"multihost {label}", step, evaluate, params0, opt, 16,
            "2 rounds × 4 chunks × forward and backward", timed=5)
    _, _, losses, launches, median_ms = runs["placed"]
    with _deterministic("multihost placed"):
        want = D.make_tp_value_and_grad(cfg, whole, mesh)(params0,
                                                          whole.train_mask)
        diff = _hold_equal(
            "multihost placed",
            D.make_tp_value_and_grad(cfg, placed, mesh)(params0,
                                                        placed.train_mask),
            want, "placed vs unplaced bundle")
    print(f"  multihost placed: median step {median_ms:.2f} ms (unplaced "
          f"{runs['unplaced'][4]:.2f} ms); largest step-0 difference from "
          f"the unplaced bundle {diff:.3e} (deterministic algorithms); "
          f"{card}")
    return {"launches": launches, "step_ms": median_ms,
            "unplaced_launches": runs["unplaced"][3],
            "unplaced_step_ms": runs["unplaced"][4],
            "loss_first": losses[0], "loss_last": losses[-1],
            "resident_bytes": sizes[0], "unplaced_bytes": sizes[1],
            "max_diff_vs_unplaced": diff}


def _launcher_run(extra: list, want_first: float, card: str) -> dict:
    """Phase 21(b): ``python -m repro_torch.launch.multihost`` in a child
    process under the env contract (one process, NCCL): exit 0, one
    ``RESULT`` line, finite and falling losses, the first loss within
    ``MULTIHOST_RTOL`` of this process's."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    env.update(PYTHONPATH=str(ROOT / "src"),
               COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               NUM_PROCESSES="1", PROCESS_ID="0")
    cmd = [sys.executable, "-m", "repro_torch.launch.multihost",
           *MULTIHOST_ARGS, *extra]
    t = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    seconds = time.perf_counter() - t
    lines = res.stdout.splitlines()
    for line in lines:
        print(f"    | {line}")
    results = [ln for ln in lines if ln.startswith("RESULT ")]
    if res.returncode != 0 or len(results) != 1:
        print(res.stderr[-4000:])
        raise AssertionError(f"the launcher exited {res.returncode} with "
                             f"{len(results)} RESULT lines")
    result = json.loads(results[0][len("RESULT "):])
    rows = [ln.split(",") for ln in lines if ln.startswith("epoch,")]
    losses = [float(r[2]) for r in rows]
    epoch_ms = [float(r[3].removesuffix("ms")) for r in rows]
    got = result["loss_first"]
    if result["processes"] != 1 or len(losses) != 5 or not all(
            math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"launcher run {extra}: {result}, {losses}")
    if abs(got - want_first) > MULTIHOST_RTOL * abs(want_first):
        raise AssertionError(f"launcher run {extra}: loss_first {got} but "
                             f"{want_first} in this process")
    median_ms = statistics.median(epoch_ms[1:])
    print(f"  exit 0 in {seconds:.1f} s; loss_first {got:.7f} against "
          f"{want_first:.7f} here (|Δ| {abs(got - want_first):.2e}); median "
          f"epoch {median_ms:.2f} ms (epochs 1–4); {card}")
    return {"result": result, "seconds": seconds, "median_epoch_ms":
            median_ms, "loss_first_here": want_first}


def multihost(dev, card: str) -> dict:
    """Phase 21: the multihost runtime on one card — the placed bundle
    (a), then the launcher three times under the env contract (b), each
    first step also computed here from the same seed."""
    from repro_torch.launch import multihost as MH
    from repro_torch.runtime import TPMesh
    from repro_torch.runtime import distributed as RD

    t0 = time.perf_counter()
    ctx = RD.initialize(device=str(dev))
    print(f"  initialize(): {ctx.num_processes} process, {ctx.device}, a "
          f"{torch.distributed.get_backend()} group of one rank")
    try:
        out = {"placed": _placed(dev, card)}
        torch.cuda.empty_cache()
        firsts = {}
        for name, extra in MULTIHOST_RUNS.items():
            args = MH.parse_args(MULTIHOST_ARGS + extra
                                 + ["--device", str(dev)])
            step, _, params, opt = MH.build(args, TPMesh(), str(dev))
            firsts[name] = step(params, opt.init(params))[2].item()
            del step, params
            torch.cuda.empty_cache()
    finally:
        RD.shutdown()
    for name, extra in MULTIHOST_RUNS.items():
        print(f"  -- launcher: {name} ({' '.join(extra) or 'the default'})")
        out[name] = _launcher_run(extra, firsts[name], card)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 21 took {out['seconds']:.1f} s")
    return out


def _flash_paths(lm_rows, gemma_info, deepseek_info, mm_info):
    """(phase 19 row, path, launches on that path) of the new flash
    shapes: each row's launches are its own case's counts (variant, head
    dims, window, softcap) from the path's main-path runs."""
    def launches(row, cells):
        shape = row["shape"]
        key = _flash_case(shape[4], shape[5], row["window"], row["softcap"])
        return sum(c["launches"]["flash_by_case"].get(key, 0) for c in cells)

    gemma = [gemma_info[k] for k in ("serve_long_context_True",
                                     "serve_long_context_False", "score")]
    deep = [deepseek_info["serve"], deepseek_info["score"]]
    vl, mg = ([mm_info[a]["serve"], mm_info[a]["score"]] for a in MM_ARCHS)
    return tuple((key, path, launches(lm_rows[key], cells))
                 for key, path, cells in (
                     ("flash_gemma2_global", "gemma2-9b (global layers)",
                      gemma),
                     ("flash_gemma2_local", "gemma2-9b (local layers)",
                      gemma),
                     ("flash_mla", "deepseek-v2-lite-16b", deep),
                     ("flash_internvl2", "internvl2-1b", vl),
                     ("flash_musicgen", "musicgen-large", mg)))


def _oneshot_entry(info, key, case_err) -> dict:
    """The ``kernels`` line's entry of the one-shot path at one dtype of
    h (phase 3)."""
    row = info[key]
    return {"name": "spmm_csr", "route": "cuda",
            "source": "src/repro_torch/kernels/spmm/csrc/spmm_csr.cu",
            "replaces": "src/repro/kernels/spmm/spmm.py:64",
            "held_against": "ref.spmm_csr_ref", "dtype": key,
            "path": "one-shot aggregate_pallas on block_sparse_dev and "
                    "square_plan_dev (phase 3), sbm_power_law n=4096, bs "
                    "128, d 128",
            "launches": row["launches"],
            "launches_by_dtype": info["launches"],
            "max_abs_err": max(case_err, row["max_abs_err"]),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "event_ms")},
            "ms_by": "profiler", "derive_ms": info["derive_ms"]}


def _flash_fp32_entry(row, path, launches, case_err) -> dict:
    """The ``kernels`` line's entry of one fp32 flash shape."""
    return {"name": "flash_attention_bhsd", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attn/csrc/"
                      "flash_attention_tf32x3.cu",
            "replaces": "src/repro/kernels/flash_attn/flash.py:105",
            "held_against": "ref.flash_ref", "variant": "mma_tf32x3",
            "shape": row["shape"], "window": row["window"],
            "softcap": row["softcap"], "path": path, "launches": launches,
            "max_abs_err": max(case_err, row["max_abs_err"]),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "bound_fp32_ms", "library_ms",
                                   "library")},
            "ms_by": "events"}


def _flash_entry(row, path, launches, case_err) -> dict:
    """The ``kernels`` line's entry of one flash shape."""
    return {"name": "flash_attention_bhsd", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attn/csrc/"
                      "flash_attention_mma.cu",
            "replaces": "src/repro/kernels/flash_attn/flash.py:105",
            "held_against": "ref.flash_ref", "shape": row["shape"],
            "window": row["window"], "softcap": row["softcap"],
            "path": path, "launches": launches,
            "max_abs_err": max(case_err, row["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "library": row["library"],
            "ms_by": "events"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this "
              "script runs on a CUDA GPU only", file=sys.stderr)
        return 1
    import torch.distributed as dist
    from repro_torch.kernels import build as kbuild

    t_start = time.perf_counter()
    print("[1/31] device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"  {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  tf32 off: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # phase 19's compiled yardstick (flex_attention) caches in the checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "torchinductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))

    print("[2/31] build")
    t0 = time.perf_counter()
    kbuild.build()
    build_s = time.perf_counter() - t0
    print(f"  {', '.join(p.name for p in kbuild.SOURCES)} built (sm_90a, "
          f"one load, one nvcc per source) in {build_s:.1f} s")

    print("[3/31] spmm kernel against its plain version; the one-shot "
          "entry points")
    spmm_err = kernel_cases(dev)
    oneshot_err = oneshot_cases(dev)
    # the skewed plan's bf16 repeat is the bf16 kernel's only other case
    oneshot_err["bfloat16"] = max(oneshot_err["bfloat16"],
                                  spmm_err["bfloat16"])
    oneshot_info = oneshot(dev)
    print("[4/31] flash kernel against its plain version")
    flash_err = flash_cases(dev)
    print("[5/31] ssd kernel against its plain version")
    ssd_err = ssd_cases(dev)

    print("[6/31] GCN main path: decoupled-pipelined TP GCN training")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        bundle, data, gcn_cfg, gcn = train(dev)
        print("[7/31] naive TP GCN training (a split and a gather per "
              "layer)")
        naive_info = naive(bundle, data, gcn_cfg, dev)
        print("[8/31] DP halo-exchange GCN training (k=1)")
        dp_info, dp_err = dp(data, dev)
        print("[9/31] out-of-core streamed GCN training (pinned host "
              "stores, a copy stream, half plans)")
        stream_info = stream(data, dev)
        print("[10/31] GAT decoupled-pipelined TP training (the score "
              "all-gathers)")
        gat_info = gat(bundle, data, dev, "decoupled_pipelined")
        print("[11/31] GAT naive TP training")
        gat_naive_info = gat(bundle, data, dev, "naive")
        print("[12/31] SAGE and GIN decoupled-pipelined TP training")
        like_info = gcn_like(bundle, data, dev)
        print("[13/31] hybrid DP×TP on a (data=1, model=1) mesh: GCN "
              "decoupled-pipelined and naive, DP, GAT")
        hybrid_info = hybrid(bundle, data, dev, {
            "decoupled_pipelined": gcn, "naive": naive_info, "dp": dp_info,
            "gat_decoupled_pipelined": gat_info}, card)
        print("[14/31] the constraint engine backend (DTensor, "
              "transitions through the choke point) beside the explicit "
              "one")
        constraint_info = constraint(bundle, data, dev, card)
        print("[15/31] spmm timing at the GCN paths' shapes")
        rows, path_err = timing(bundle, data, dev)
    finally:
        dist.destroy_process_group()
    del bundle, data
    torch.cuda.empty_cache()

    print("[16/31] LM main path, serving: Zamba2-2.7B generate")
    cfg, params, batch, serve_info, score_info = serve(dev)
    print("[18/31] fp32 cross-check at full width, kernels vs plain")
    fp32_err, fp32_launches, fp32_cases = cross_check_fp32(
        cfg, params, batch["tokens"][:1, :512], batch["targets"][:1, :512],
        dev)
    del params
    _lm_free()
    print("[19/31] flash and ssd timing at the LM paths' shapes")
    t = time.perf_counter()
    lm_rows = lm_timing(dev)
    _lm_free()
    print(f"  phase 19 took {time.perf_counter() - t:.1f} s")
    print("[20/31] single-device trainer: GCN, SAGE, GIN, GAT and R-GCN "
          "coupled and decoupled, checkpoints, R-GCN TP, the example")
    single_info = single(dev)
    print("[21/31] multihost: the placed bundle, the launcher under the env "
          "contract")
    multihost_info = multihost(dev, card)
    _lm_free()
    print("[22/31] gemma2-9b at full width and depth: generate 1 × 8192 "
          "with ring caches and with dense caches, scoring")
    gemma_info = gemma2(dev)
    print("[23/31] deepseek-v2-lite-16b at full width and depth: generate "
          "2 × 2048 (MLA, MoE), scoring")
    deepseek_info = deepseek(dev)
    print("[24/31] mamba2-1.3b at full width and depth: scoring, generate")
    mamba_info = mamba2(dev)
    print("[25/31] fp32 cross-checks of the new configs, kernels vs plain")
    xcheck_errs, xcheck_launches, xcheck_cases = lm_cross_checks(dev)
    for key, n in xcheck_cases.items():
        fp32_cases[key] = fp32_cases.get(key, 0) + n
    print("[26/31] InternVL2-1B and MusicGen-large at full width and depth: "
          "generate 2 × 2048 behind the prefix, scoring")
    mm_info = multimodal(dev)
    print("[27/31] LM training at full width and depth: InternVL2-1B and "
          "Granite-MoE-1B-A400M, the fp32 cross-checks, the kernels' "
          "refusals")
    t = time.perf_counter()
    train_info = lm_train(dev, card)
    print(f"  phase 27 took {time.perf_counter() - t:.1f} s")
    print("[28/31] the LM's NeutronTP sharding on a (data=1, model=1) mesh: "
          "Zamba2-2.7B's sharded scoring (flash, SSD), Granite-MoE's "
          "sharded training step")
    shard_info = sharded_lm(dev, card)
    print("[29/31] sharded LM serving on a (data=1, model=1) mesh: "
          "Zamba2-2.7B's sharded prefill (flash) and greedy decode, the "
          "fp32 cross-checks of the three cache layouts")
    serve_shard_info = sharded_serving(dev, card)
    print("[30/31] the megatron strategy on a (data=1, model=1) mesh: "
          "Zamba2-2.7B's scoring (flash, SSD) and serving (flash), "
          "Granite-MoE's training step")
    megatron_info = megatron(dev, card)
    print("[31/31] the dry-run (launch/dryrun.py, torch's fake backend, "
          "no card) of phases 28 and 30's cells against the card's")
    dryrun_info = dryrun_check(shard_info, megatron_info, card)
    script_s = time.perf_counter() - t_start
    print(f"  phases 1–31 took {script_s:.1f} s")

    fwd, bwd, nl0 = rows["forward"], rows["backward"], rows["naive_l0"]
    fl, sd = lm_rows["flash"], lm_rows["ssd"]
    print(json.dumps({"timing": rows, "oneshot": oneshot_info,
                      "gcn": gcn, "naive": naive_info,
                      "dp": dp_info, "stream": stream_info,
                      "gat": gat_info, "gat_naive": gat_naive_info,
                      "sage": like_info["sage"], "gin": like_info["gin"],
                      "hybrid": hybrid_info,
                      "constraint": constraint_info, "build_s": build_s,
                      "serve": serve_info,
                      "score": score_info, "lm_timing": lm_rows,
                      "fp32_logits_err": fp32_err,
                      "single": single_info, "multihost": multihost_info,
                      "gemma2": gemma_info, "deepseek": deepseek_info,
                      "mamba2": mamba_info,
                      "fp32_xcheck_logits_err": xcheck_errs,
                      "multimodal": mm_info, "lm_train": train_info,
                      "sharded_lm": shard_info,
                      "sharded_serving": serve_shard_info,
                      "megatron": megatron_info,
                      "dryrun": dryrun_info,
                      "script_s": script_s, "card": card}))
    print(json.dumps({"kernels": [{
        "name": "spmm_csr", "route": "cuda",
        "source": "src/repro_torch/kernels/spmm/csrc/spmm_csr.cu",
        "replaces": "src/repro/kernels/spmm/spmm.py:64",
        "held_against": "ref.spmm_ref (tiles), ref.spmm_csr_ref",
        "launches": gcn["launches"] + naive_info["launches"]
        + dp_info["launches"] + stream_info["launches"]
        + gat_info["launches"] + gat_naive_info["launches"]
        + like_info["sage"]["launches"] + like_info["gin"]["launches"]
        + sum(h["launches"] for h in hybrid_info.values())
        + sum(c["launches"] for c in constraint_info.values())
        + single_info["rgcn tp"]["launches"]
        + multihost_info["placed"]["launches"]
        + multihost_info["placed"]["unplaced_launches"],
        "launches_by_path": {"decoupled_pipelined": gcn["launches"],
                             "naive": naive_info["launches"],
                             "dp": dp_info["launches"],
                             "stream": stream_info["launches"],
                             "gat_decoupled_pipelined": gat_info["launches"],
                             "gat_naive": gat_naive_info["launches"],
                             "sage": like_info["sage"]["launches"],
                             "gin": like_info["gin"]["launches"],
                             **{f"hybrid_{k}": h["launches"]
                                for k, h in hybrid_info.items()},
                             **{f"constraint_{k}": c["launches"]
                                for k, c in constraint_info.items()},
                             "rgcn_decoupled_pipelined":
                                 single_info["rgcn tp"]["launches"],
                             "multihost_placed":
                                 multihost_info["placed"]["launches"],
                             "multihost_unplaced": multihost_info[
                                 "placed"]["unplaced_launches"]},
        "max_abs_err": max(spmm_err["float32"], path_err, dp_err),
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"], "ms_by": "profiler",
        "event_ms": fwd["event_ms"], "backward_ms": bwd["ms"],
        "backward_library_ms": bwd["library_ms"],
        "naive_l0_ms": nl0["ms"], "naive_l0_plain_ms": nl0["plain_ms"],
        "naive_l0_bound_ms": nl0["bound_ms"],
        "naive_l0_library_ms": nl0["library_ms"]},
        *[_oneshot_entry(oneshot_info, key, oneshot_err[key])
          for key in ("float32", "bfloat16")], {
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attn/csrc/"
                  "flash_attention_mma.cu",
        "replaces": "src/repro/kernels/flash_attn/flash.py:105",
        "held_against": "ref.flash_ref", "shape": fl["shape"],
        "path": "zamba2-2.7b",
        "launches": serve_info["launches"]["flash"]
        + score_info["launches"]["flash"],
        "max_abs_err": max(flash_err, fl["max_abs_err"]),
        "ms": fl["ms"], "plain_ms": fl["plain_ms"],
        "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
        "library_ms": fl["library_ms"], "ms_by": "events"},
        *[_flash_entry(lm_rows[key], path, launches, flash_err)
          for key, path, launches in _flash_paths(lm_rows, gemma_info,
                                                  deepseek_info, mm_info)],
        {
        "name": "ssd_intra_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_intra_chunk.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:61",
        "held_against": "ref.ssd_intra_chunk_ref", "shape": sd["shape"],
        "path": "zamba2-2.7b",
        "launches": serve_info["launches"]["ssd"]
        + score_info["launches"]["ssd"],
        "max_abs_err": max(ssd_err, sd["max_abs_err"]),
        "ms": sd["ms"], "plain_ms": sd["plain_ms"],
        "bound_ms": sd["bound_ms"], "bound_by": sd["bound_by"],
        "library_ms": None, "ms_by": "profiler",
        "event_ms": sd["event_ms"]}, {
        "name": "ssd_intra_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_intra_chunk.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:61",
        "held_against": "ref.ssd_intra_chunk_ref",
        "shape": lm_rows["ssd_n128"]["shape"], "path": "mamba2-1.3b",
        "launches": mamba_info["serve"]["launches"]["ssd"]
        + mamba_info["score"]["launches"]["ssd"],
        "max_abs_err": max(ssd_err, lm_rows["ssd_n128"]["max_abs_err"]),
        **{k: lm_rows["ssd_n128"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "event_ms")}, "ms_by": "profiler"}, {
        **_flash_fp32_entry(lm_rows["flash_fp32"],
                            "fp32 cross-checks (phases 18, 25)",
                            fp32_launches + xcheck_launches, flash_err),
        "launches_by_case": fp32_cases}, *[
        _flash_fp32_entry(lm_rows[key], path, fp32_cases.get(
            _flash_case(*[lm_rows[key]["shape"][i] for i in (4, 5)],
                        lm_rows[key]["window"], lm_rows[key]["softcap"],
                        "mma_tf32x3"), 0), flash_err)
        for key, path in (
            ("flash_fp32_zamba2", "fp32 cross-checks (phases 18, 25), "
             "Zamba2's case at its full prefill's shape"),
            ("flash_fp32_gemma2_global", "fp32 cross-checks (phase 25), "
             "gemma2-9b global layers"),
            ("flash_fp32_gemma2_local", "fp32 cross-checks (phase 25), "
             "gemma2-9b local layers"),
            ("flash_fp32_mla", "fp32 cross-checks (phase 25), "
             "deepseek-v2-lite-16b"))], {
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attn/csrc/"
                  "flash_attention_mma.cu",
        "replaces": "src/repro/kernels/flash_attn/flash.py:105",
        "held_against": "ref.flash_ref", "shape": fl["shape"],
        "path": "zamba2-2.7b sharded scoring (phase 28, mesh 1×1)",
        "launches": shard_info["scoring"]["launches"]["flash"],
        "max_abs_err": max(flash_err, fl["max_abs_err"]),
        **{k: fl[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}, "ms_by": "events"}, {
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attn/csrc/"
                  "flash_attention_mma.cu",
        "replaces": "src/repro/kernels/flash_attn/flash.py:105",
        "held_against": "ref.flash_ref", "shape": fl["shape"],
        "path": "zamba2-2.7b sharded serving prefill (phase 29, mesh 1×1)",
        "launches": serve_shard_info["zamba2"]["launches"]["flash"],
        "max_abs_err": max(flash_err, fl["max_abs_err"]),
        **{k: fl[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}, "ms_by": "events"}, {
        "name": "ssd_intra_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_intra_chunk.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:61",
        "held_against": "ref.ssd_intra_chunk_ref", "shape": sd["shape"],
        "path": "zamba2-2.7b sharded scoring (phase 28, mesh 1×1)",
        "launches": shard_info["scoring"]["launches"]["ssd"],
        "max_abs_err": max(ssd_err, sd["max_abs_err"]),
        **{k: sd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "event_ms")},
        "ms_by": "profiler"}, {
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attn/csrc/"
                  "flash_attention_mma.cu",
        "replaces": "src/repro/kernels/flash_attn/flash.py:105",
        "held_against": "ref.flash_ref", "shape": fl["shape"],
        "path": "zamba2-2.7b megatron scoring and serving prefill "
                "(phase 30, mesh 1×1)",
        "launches": megatron_info["scoring"]["launches"]["flash"]
        + megatron_info["serving"]["launches"]["flash"],
        "max_abs_err": max(flash_err, fl["max_abs_err"]),
        **{k: fl[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}, "ms_by": "events"}, {
        "name": "ssd_intra_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_intra_chunk.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:61",
        "held_against": "ref.ssd_intra_chunk_ref", "shape": sd["shape"],
        "path": "zamba2-2.7b megatron scoring (phase 30, mesh 1×1)",
        "launches": megatron_info["scoring"]["launches"]["ssd"],
        "max_abs_err": max(ssd_err, sd["max_abs_err"]),
        **{k: sd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "event_ms")},
        "ms_by": "profiler"}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
