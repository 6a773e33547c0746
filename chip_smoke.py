#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) end to end on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as ``[phase] start`` ... ``[phase] ok in N s``; any
failure raises and exits non-zero, nothing is caught and carried on:

  device        card name and power limit (nvidia-smi), torch and CUDA versions
  build         nvcc builds kernels B1 (gram.cu), B3 (gram_q8.cu), B2 (smo.cu),
                B4 (flash_attention.cu) and E1 (exact_epoch.cu) from
                src/repro_torch/kernels/csrc,
                in parallel; B4's registers, spills and shared memory (ptxas)
                and the HGMMA count of each body at each (Dqk, Dv) pair, and
                the bf16 body's ring depth (cuobjdump -sass): no spills,
                and the bf16 body on the tensor cores; B1's and B3's
                registers, spills and HGMMA counts: no spills, on the tensor
                cores; B2's registers and spills at each ring depth and E1's
                at each width: no spills
  B4 vs plain   flash-attention kernel against its plain version: causal and
                not, S in {1, 63, 64, 127, 128, 129, 255, 257, 1000}, (Hq, Hkv)
                in {(4, 4), (16, 8), (32, 4), (16, 2)}, D in {64, 96, 128}, fp32
                and bf16; not causal with k, v of their own length, (S, S_kv)
                in {(37, 16), (64, 1024), (129, 1), (300, 257), (1, 1000),
                (128, 129)}; bf16 against the plain version at the kernel's
                kv tile, and within 3e-2 of it with p in fp32 (_flash's
                arithmetic); at S 1000 also the plain version on the CPU
                against the card; the pairs (Dqk, Dv) (112, 112), (192, 128)
                and (96, 64) at S in {1, 129, 700}, (Hq, Hkv) in {(4, 4),
                (16, 8)}, causal and not, both dtypes, and MLA's strided v
  B4 timing     B4 at the driver's shape (qwen3-0.6b, batch 32, S 256), two
                prefill shapes (qwen3-0.6b 1 x 4096, tinyllama-1.1b 4 x 2048),
                phi-3-vision's prefixed prefill (4 x 640, 32 heads of 96),
                seamless-m4t's encoder (4 x 1024, not causal) and its
                cross-attention (4 x 64 over 1024), jamba's attention layer
                (2 x 512, 32 / 8 heads of 128), deepseek-v2's MLA prefill (2 x
                512, 128 heads at (192, 128); the strided v's copy timed
                apart), kimi-k2's prefill (2 x 512, 64 / 8 heads of 112) and
                the deepseek driver backbone's batch (32 x 64, 4 heads at
                (96, 64)), beside its plain version, SDPA (where it takes the
                shape) and its bound; back to back (device time) and one call
                alone (host launch cost included); the bf16 excess over one
                ulp as a share of the rounding slack at each shape
  B1 vs plain   gram kernel against its plain PyTorch version, four kinds at
                ragged shapes; against fp64: rows of x with one nonzero element
                (p 100 and 784, 1e-6 relative: fails if a piece product is
                dropped) and cancelling sums (2e-4 of sum |x||z|)
  B3 vs plain   int8 gram kernel against dequantise-then-gram, four kinds at
                ragged shapes, affine and symmetric codecs
  B3 vs fp64    B3 against K in fp64 at the streamed chunk's shape
                (tools/b3_probe.py's cases: symmetric linear, RBF at 1/p, the
                cancelling sums of both codecs), each at or under the SIMT
                B3's largest error
  B1 / B3 tiny elements   rows of one 2^20 and 2^-115 elsewhere, the tiny
                terms the only nonzero ones: fp32 keeps them, B1 and B3
                return 0 (a deliberate difference)
  data          an MNIST-shaped 10-class problem: 60000 + 10000 rows, p = 784
  B1 vs plain, main-path shapes   K_mm, K_nm and the prediction features;
                K_mm against fp64 within the fp32 form's rounding bound, at
                the median gamma and 4x it
  B2 vs plain   SMO-epoch kernel against its plain version at small shapes
  main path     LPDSVM(...).fit -> predict on the card (RBF, median gamma,
                C = 1, budget 2048, tol 1e-2), with launch counts reset just
                before and read just after; decision values against the plain
                path from the same factor
  B2 vs plain, main-path shape    a full epoch from zero and a cheap epoch
                from the fitted state
  card vs cpu   a small fit on the card against the same fit on the CPU
  polished main path   the main path's fit with polish=True on its factor,
                counts reset around it: a line a level (rows, routing,
                epochs, B2 launches, gap, seconds), held against the cold
                fit (violations under tol, alphas in their box, w within
                0.05 of its scale, test error within 0.03, predictions
                agreeing on 98%, every gap within the C tol m_t that the
                KKT stop implies); the duality gaps measured against the
                cold fit and a cold solve at the ladder's cadence, per task
                (tests/test_polish.py's slack) and largest against largest
                (benchmarks/polish.py's); the final level's fp64 warm start
                timed
  timing        CUDA-event times of each kernel at the main path's shapes,
                beside its plain version, a library call and its bound (B1
                one call alone and back to back at K_nm and predict); the
                cheap epoch's active rows and ns per active row; stage 2
                solved again on the main path's factor with CUDA events
                around every B2 launch: their sum against the wall time
  B3 vs plain, chunk shape        B3 at the streamed stage-1 chunk shape; its
                pre-pass's bf16 pieces of the landmarks bit-equal to
                split_bf16x3 on the CPU
  streamed path LPDSVM(stream_config=StreamConfig(256 MiB, int8 stage 1))
                .fit -> predict on the main path's data: both stages routed to
                streaming, counts reset just before and read just after,
                held against the monolithic fit; stage 1 alone and stage 2
                alone (f32, then bf16 blocks) for their peak device memory
  polished streamed path   the streamed path's fit (stage 1 included) with
                polish=True, counts reset around it: the final level streams,
                each coarse level's routing printed, held against the cold
                streamed fit as above
  trace, streamed path            the streamed path's fit (stage 1 included)
                under a core/trace.py Tracer, counts reset around it: bit-equal
                to the untraced fit (G, alphas, w, epochs, wire bytes); the
                per-category seconds (the summary), B2's device seconds
                (CUDA-event spans) against stage 2's wall, the H2D copies'
                device time under B2, the compute row's idle share and largest
                gaps in stage 2, the traced fit's seconds beside the untraced
                one's; the trace exported and read back; then the driver with
                --stream --trace-summary at reduced rows (in this process)
  streamed path, int8 blocks      stage 2 of the streamed path on its factor
                with block_dtype="int8", B2's count reset around it: the first
                pass's bytes against the byte model of the int8 wire (codes +
                8 B a group, tails padded to the tile) and the f32 wire's
                n B' 4, encode seconds, stage-2 seconds beside the f32 wire's,
                violations under tol, peak device memory within the budget
                plus the task-state allowance; bit-equal to the monolithic
                solve on the decoded G; predictions INT8_MIN_AGREE alike to
                the f32 streamed fit's (the f32 solve's own spread between
                tol 1e-2 and 1e-3), test error within 0.5 points
  streamed path, block cache      stage 2 of the streamed path (f32 wire) on
                its factor at a 480 MiB budget with 224 MiB carved for the block
                cache (core/block_cache.py), B2's count reset around it: the
                tile (the uncached fit's), alphas, w and epochs bit-equal to the
                uncached fit, hits + misses equal to its compacted bytes, H2D
                bytes less the hits, hits > 0, residency within the cache
                budget, peak device memory within the budget plus the
                allowance; G bytes, hits, misses, evictions, the cheap epochs'
                hit rate, copy, compaction and stage-2 seconds; the same under
                a Tracer (the compute row's idle share); at a reduced size
                (6000 x 784, B 512) bf16 and int8 blocks, a two-block cache
                that evicts, and the grid task farm, each bit-equal to its
                uncached run
  checkpoint and resume, streamed path   the cached stage 2 with a snapshot
                every 5 full passes, killed (faults.SimulatedKill) at the third
                snapshot's boundary and resumed: bit-equal to the
                uninterrupted run; snapshot bytes and seconds, resume
                seconds, stage-2 seconds with and without snapshots; stage 1
                on the int8 wire killed at chunk 3 by an IO fault and resumed
                (G bit-equal, chunks read back); the driver's --libsvm route
                (3000 rows) killed with SIGKILL once a snapshot exists, then
                --resume: exit 0, its "resuming" line
  windowed B2 vs plain            B2's window form on one streamed G block
  timing, streamed kernels        B3 at the chunk shape and windowed B2 on
                one block, beside plain versions, library calls and bounds
                (B3's by its bf16 passes, the CUDA-core figure beside it)
  streamed stage 1 at scale       1,000,000 x 784 rows (mnist8m's shape, cut
                from 8.1 M rows), default StreamConfig, f32 and int8 wires:
                counts reset around each wire, B1 and B3 against their plain
                versions on its first chunk (both also timed there), G rows
                against the plain path
  streamed vs monolithic, one factor   the main path's factor, moved to
                pinned host memory, through the streamed stage 2 against the
                main path's own solve: q, epochs, alphas, dual objective
  end-to-end driver, full width   the paper's driver (launch/train_svm.py):
                qwen3-0.6b at 28 layers and d 1024 from a seeded init on the
                card, 8000 class-conditioned documents of 256 tokens, features
                through B4 in every layer, LPD-SVM (RBF, median gamma, C 8,
                budget 1024) on the 80/20 split; counts reset just before and
                read just after; the feature time split into B4, the bf16
                products and the rest
  backbone card vs cpu, 2 layers  the same full-width weights cut to 2 layers:
                the card's features against the port's CPU path on 16 documents
  class signal by depth           the driver's head on the same documents at
                0 layers (the mean input embedding) and at the 2-layer cut;
                the 0-layer error must lie ten standard errors below chance
  driver --polish                 launch/train_svm.py --polish through its
                CLI (reduced backbone, 400 documents): exit code 0, its
                polish level lines, test error below chance
  grid search, main path          core/cv.py's grid_search on the main path's
                data at full width: gammas g/2, g, 2g (g the median gamma) x
                C 0.25, 1, 4 x 3 folds, 1215 binary SVMs, T = 135 tasks a
                cell; a line a cell (T, n_pad, epochs, B2 launches read
                around it, the seconds of its fp64 warm start, stage-2
                seconds, CV error); B1 launched twice a gamma and never a
                cell, each cell's B2 launches its largest epoch count, the
                best error below chance; the cold ladder at g within 0.03
  grid cell, held                 one cell (g, C 1) through solve_batch:
                violations under tol, alphas in their box, padding alphas 0;
                B2's full and cheap epoch at T = 135 beside T = 45, and the
                blocks an SM and waves; at a reduced size (6000 x 784, 10
                classes, sep 0.1, B 512, C 1/16) the card's dual objectives
                against the CPU's solve of the same cell (5e-3)
  grid search, card vs cpu        the reduced grid (1 gamma x C 1/16, 1/4)
                on the card and on the CPU: errors within 0.01, same cell
  grid search, polished           the reduced grid with polish=True: the
                same cell, errors within 0.03
  grid task farm, ladder and concurrent   at the reduced size (T = 270:
                C 1/16 and 1/4 x 3 folds x 45 pairs, G from pinned host
                memory): with every epoch a full pass the farm's per-cell
                alphas and epochs equal the serial streamed C loop's on the
                card; without the ladder each cell equals its cold solo
                streamed solve and the grid's G bytes stay within 1.3x of
                the largest cell's; the farm on the card against the farm on
                the CPU (dual objectives within 5e-3, the same cell)
  grid search, streamed serial    at 256 MiB with farm=False: the main
                path's factor from pinned host memory through cross_validate
                equals the card factor's errors; a grid whose f32 stage 1
                streams (so every cell streams) within 0.01 of the
                monolithic grid; with farm=None the same grid on the grid
                task farm at full width (T = 270): CV errors within 0.01 of
                the serial streamed grid's and the same best cell where its
                lead is over 0.01, epochs, G bytes, B2 launches and seconds
                beside the serial grid's sums, the farm's peak device memory
                within the budget plus the task-state allowance; without the
                ladder (warm_start=False) the concurrent farm beside the cold
                serial streamed grid: equal errors and epochs, G bytes
                against the largest cell's and the cells' sum
  driver --grid                   launch/train_svm.py --grid-cs 1,4
                --grid-gammas g/2,g --grid-folds 3 through its CLI: exit 0,
                the grid lines, the refit below chance; then with --stream
                (in this process): the farm's line a gamma, exit 0
  solve_compact                   the main path's largest OVO task (its rows of
                the main path's factor gathered on the card) through
                core/compact.py's bucket-compaction solver, B2 with T = 1:
                one launch an epoch, its dual objective within 1e-3 of
                solve_batch's on the task, fewer rows swept than without
                shrinking
  libsvm ingest, full width       the main path's rows, each column keeping its
                entries at a rate drawn from Beta(0.19, 0.81) (about 146 of 784
                a row, as LIBSVM's mnist), written by data/libsvm_format.py's
                write_libsvm (60000 + 10000 rows) and read back into CSR: rows
                a second, nnz, bytes; the CSR's indices equal to the mask, its
                values within %g's rounding
  libsvm factor, CSR vs dense     compute_factor_streamed_csr at the driver's
                --device-budget-mb 256 on the f32 (B1) and int8 (B3) wires
                against compute_factor_streamed on the densified rows with the
                same landmark rows: G, landmarks, projector, eigvals bit-equal;
                stage-1 seconds, the host densify seconds against slicing
  driver --libsvm, full width     launch/train_svm.py's main with --libsvm
                --n-features 784 --budget 2048 --C 1 --device-budget-mb 256 (in
                this process), then with --stage1-dtype int8, counts reset
                around each: the reference's lines, both stages streamed, B1
                (or B1 + B3) and B2 launched as the chunks and blocks say; the
                votes of predict_from_factor against predict on the dense
                training rows (0.999 alike on the f32 wire, 0.99 on the int8
                wire's codec), the test file's error
  libsvm bad rows                 6000 rows plus a non-finite value, a 0-based
                index and a malformed token: --on-bad-row skip reports 3
                skipped and gives the clean file's factor and training error
                bit for bit; without it BadRowError names line 6001
  save / load                     the main path's and the streamed path's fits
                saved (.npz bytes, seconds) and loaded onto the card: decision
                values on the test rows bit-equal; predict_from_factor raises
  predict_from_factor, card G vs host G   the main path's factor scored from
                its card G and from a pinned host copy: identical votes
  shard store, ingest and reuse   the driver's --libsvm run above with
                --shard-dir, once to ingest the text into 4096-row f32 shards
                and once to reuse them with every parse function raising:
                parse, write and open seconds, bytes written, the walls against
                --libsvm without a store, the shard io line; the reused run's
                factor and training error bit-equal.  An int8 store written
                with ShardWriter from the parsed CSR: its stored codes through
                B3 give compute_factor_streamed's G at 4096-row chunks on the
                int8 wire bit for bit, with no host encode.  A data shard
                corrupted on read (a shard_corrupt fault): quarantined, parsed
                again from the text, the factor unchanged
  stage 2 off a spilled G, full width   the streamed path's fit with spill_g
                (f32 wire): factor.G a GShardView of 15 shards, stage 1's pinned
                host buffers (none of n rows), shard reads, bytes read and
                verified, read GB/s, read and checksum seconds, the compute
                row's idle share in stage 2 (tracer); its stage 2 (whose
                derived cache holds no block) bit-equal to the uncached solve
                off a pinned copy of G; the cached solve (480 MiB, 224 MiB of
                cache) off the spilled G, with one G shard corrupted on read
                and rebuilt through B1, serving cache hits and bit-equal to
                the cached and the uncached solves off the pinned G

  task farm, streamed path        core/distributed.py's farm on two workers
                of the card ([cuda:0, cuda:0]; on every card too where there
                are more): the streamed path's factor and 45 tasks at 256 MiB,
                f32 wire, overlapped and serial, against one device: epochs
                equal, alpha and w bit-equal (the reference's farm tolerance,
                rtol 1e-4 / atol 1e-5, printed), the overlapped first pass one
                device's bytes and
                bytes_put above bytes_h2d, the serial first pass at least 1.9x;
                B2 launches a worker, stage-2 seconds; traced, each device
                row's idle share and the card's compute (either worker)
  task farm, wires and cache      reduced (6000 x 784, B 512): the first
                pass's bytes on f32, bf16 and int8 blocks against the byte
                model, each wire's farm bit-equal to one device, each
                worker's cache bit-equal to the uncached farm (f32); the
                grid task farm's C ladders split whole over the two workers,
                equal to the serial C loop
  task farm, faults               reduced: a device loss at worker 1 (fault
                site "h2d", device cuda:0/w1, fail_fast off) re-split onto
                worker 0, equal to the clean farm (its per-epoch bytes a clean
                one-worker run's); a kill at the third full
                pass and the resume, bit-equal; a "stall" at the reader's
                hand-off under watchdog_seconds 2 raises WatchdogTimeout in
                the watchdog's time plus 5 s
  stage 1 over devices            the streamed path's stage 1 (60000 x 784) on
                both wires, chunks round-robin over two workers: G bit-equal
                to one device's; B1 / B3 launches a worker
  driver --no-overlap             launch/train_svm.py --stream --no-overlap
                (reduced backbone, 400 documents, in this process) with the
                local device list patched to [cuda:0, cuda:0], so LPDSVM.fit
                routes onto the serial farm: its stage-2 line prints
                "2 device(s)", each worker launches B2, and the first pass
                is twice one device's bytes
  serve, qwen3-0.6b full width    launch/serve.py's serve at 28 layers, d
                1024 (seeded weights, batch 8, prompt 64, gen 64, kv_len
                128): its two lines and peak device memory; generate on the
                same weights gives its tokens, warm: prefill-by-decode
                seconds, ms a generated step, tok/s; the prefill step
                (make_prefill_step: forward, B4 once a layer, counted)
                against decode's logits at the prompt's last position; 8
                teacher-forced decode steps on the card against the CPU's;
                the decode step's device kernel time and idle share (the
                profiler, 4 steps); a ring of 32 slots against the full
                cache: within the bound for pos < 32, finite beyond, its
                slots holding the last 32 positions.  Every logit bound is
                serve_logit_tol, sqrt(2L) bf16 steps of the largest logit
  serve, dense configurations     tinyllama-1.1b, codeqwen1.5-7b and
                minitron-4b at full width, tinyllama at full depth, the other
                two cut to 16 of their 32 layers (batch 4, prompt 64):
                one prefill step through B4 (launches counted) against
                decode's logits at the prompt's last position, then 8
                greedy decode steps; ms a step, peak device memory
  serve, phi-3-vision-4.2b full width   32 layers, d 3072, head dim 96
                (seeded): serve at batch 4, prompt 64, gen 16 (text only, as
                the reference serves it); the text prefill step (B4 once a
                layer) against decode's logits at the prompt's end; the
                prefill over the config's 576 patch rows and the prompt (S
                640, B4 once a layer); B4 against its plain version on layer
                0's own q, k, v at that shape; the prefixed forward at full
                width cut to 2 layers, card against CPU at every position
  serve, seamless-m4t-large-v2 full width   24 encoder + 24 decoder layers, d
                1024, vocab 256206 padded to 256512 (seeded): serve at batch
                4, prompt 64, gen 16 (16 frames; B4 once an encoder layer);
                the prefill step and forward over the config's 1024 frames
                (B4 once an encoder layer, twice a decoder layer); the
                encoder's memory, prefill_cross_attention and 64
                teacher-forced decode steps against the prefill step and
                forward's logits at every position (sqrt(3L) bf16 steps: a
                decoder layer's three sublayers); B4 against its plain
                version on encoder layer 0's q, k, v (4 x 1024) and decoder
                layer 0's cross-attention (4 x 64 over 1024)
  serve, rwkv6-1.6b full width    24 RWKV6 layers, d 2048, no attention
                (seeded): serve at batch 4, prompt 32, gen 32 (no KV cache:
                a recurrent state a layer), then generate warm: ms a step,
                tok/s; the prefill step at 4 x 512 (32 chunks of 16), first
                call and warm, no B4; forward over 64 tokens (the chunked
                form) against 64 teacher-forced decode steps (the
                recurrence) at every position; full width cut to 2 layers,
                card against CPU
  serve, jamba-v0.1-52b full width, 8 layers   d 4096, 32 / 8 heads of 128,
                16 experts top-2, cut to 8 of 32 layers (one group: Mamba
                at 0-3 and 5-7, attention at 4, MoE at 1, 3, 5, 7; 13.27 B
                parameters): generate at batch 4, prompt 32, gen 16, warm;
                the prefill step at 2 x 512 (two Mamba chunks of 256; B4
                once, counted), first call and warm; forward against 512
                teacher-forced decode steps at all 2 x 512 positions,
                decode's routes and kept pairs pinned to the forward's (the
                pairs dropped a MoE layer printed; decode's own top-2 may
                leave the pin only below a 0.04 margin, on at most 6% of the
                tokens): in bf16 its distance in sqrt(2L) steps printed, with
                the stack's gain (one bf16 step on layer 0's output carried
                to the logits) and the share of layer 0's Mamba products
                that round apart at T 512 and T 1; B4 against its plain
                version on layer 4's own q, k, v; then the weights cast to
                fp32 in place, the same pins: forward against decode within
                sqrt(2L) bf16 steps, and bf16 decode no further from the
                fp32 forward than 1.5 x the bf16 forward.  bf16 forward
                against decode is held at sqrt(sum g_i^2) bf16 steps, g_i
                each of the 2L sublayers' gain (one bf16 step on the
                residual stream as that sublayer's add leaves it, routes
                pinned, carried to the logits; each under 32 steps)
  serve, deepseek-v2-236b full width, 4 layers   d 5120, 128 heads, MLA
                (kv_lora 512, q_lora 1536, q / k 192 wide, v 128), 160
                experts top-6 + 2 shared, cut to 4 of 60 layers (the dense
                layer and 3 MoE layers, 13.30 B parameters): generate at
                batch 2, prompt 512, gen 32 (the absorbed decode over the
                latent cache); the prefill step at 2 x 512 (B4 once a layer
                at (192, 128)); forward against 512 teacher-forced decode
                steps at all positions, routes and kept pairs pinned, within
                sqrt(2L) bf16 steps (each sublayer's gain printed beside it);
                B4 against its plain version on layer 0's own q, k, v;
                capacity drops, peak memory
  serve, kimi-k2-1t-a32b full width, 2 layers   d 7168, 64 / 8 heads of 112,
                384 experts top-8 + 1 shared, cut to 2 of 61 layers (the dense
                layer and one MoE layer, 19.94 B parameters): the same checks
  E1 vs plain                     kernel E1 (the exact solver's epoch) on the
                binary Table 2 problem's Q (14000 x 14000 from B1, 0.78 GB)
                against its plain version on the card for 3 epochs from alpha
                0: alpha, grad, viol and the moving steps equal; the third
                epoch's ms beside the plain version's and the bound (the
                moving rows' bytes), an epoch of still steps (C 0) for the
                split of a step's time; a ragged n and one past the
                shared-memory limit (grad in global memory), equal too
  Table 2, binary                 make_checker 20000 rows (3 cells, a 70/30
                split), RBF gamma 8, C 16: LPD-SVM and LLSVM (budget 1024,
                chunks of 2000), primal SGD (3000 steps) on LPD's factor and
                ExactDualSVM on all 14000 training rows, counts reset around
                each fit and prediction: train and predict seconds, test
                error, epochs, launches of B1, B2 and E1; LPD within 0.04 of
                exact's test error, LPD's training error no worse than
                LLSVM's, LPD's primal objective no worse than SGD's
  Table 2, multiclass             the main path's generator at 14000 rows
                (p 784, 10 classes, a 70/30 split), C 1, RBF at the median
                gamma: LPD-SVM (budget 1024) against ExactDualSVM's 45 pairs,
                within 0.04; E1 once an epoch, B1 twice a pair
  B4 gradient vs plain autograd   B4's autograd Function at the driver's
                shape (B 32, S 256, 16/8 heads of 128) and at D 64: one B4
                launch forward, the gradient its fp32 recompute rounded once
                to bf16, against autograd through the fp32 plain version
                within 2^-8 of the largest element plus the two fp32
                computations' difference; forward and backward ms
  train, qwen3-0.6b full width    launch/train.py's train at 28 layers, d 1024
                (seeded, AdamW, B 8, S 256, 20 steps): its lines, ms a step
                after the first, peak device memory against the reckoned
                one, B4 twice a layer a step (forward and remat recompute),
                the last loss below the first
  train step profile, qwen3-0.6b  2 steps of the same at full width under
                torch.profiler after a warm one: device kernel time a step,
                kernels a step, idle share, B4's time, the largest kernels
  train, tinyllama-1.1b full width   the same at 22 layers, d 2048, D 64,
                3 steps
  train, phi-3-vision-4.2b full width   the same at 32 layers, d 3072, D 96,
                B 2, 576 patch rows ahead of 64 tokens (the loss over the
                tokens), 3 steps; the last loss below the first
  train, seamless-m4t-large-v2 full width   the same at 24 + 24 layers, d
                1024, B 4, S 64 with 32 frames (cross-attention over S_kv 32,
                B4 four times a decoder layer and twice an encoder layer a
                step), 3 steps; the last loss below the first
  train, rwkv6-1.6b full width    launch/train.py's train at 24 layers, d
                2048 (B 4, S 256, 3 steps): peak device memory against the
                reckoned 19 GB, no B4, the last loss below the first
  train, deepseek-v2-236b full width, 1 layer   make_train_step on the dense
                first layer at full width (MLA, d_ff 12288; 1.39 B parameters)
                with AdamW (B 2, S 256, 3 steps): losses, ms a step, peak
                device memory against the reckoned, B4 twice a step at (192,
                128), the last loss below the first
  train, kimi-k2-1t-a32b full width, 1 layer   the same on kimi-k2's dense
                first layer (64 / 8 heads of 112, d_ff 18432; 2.87 B
                parameters) with its Adafactor
  train, jamba-v0.1-52b full width, 2 layers   make_train_step on the cut
                to layers 0 (Mamba + dense FFN) and 1 (Mamba + MoE), 3.73 B
                parameters (B 2, S 256, 3 steps): the fp32 leaves and their
                AdamW state fp32, losses and aux, seconds a step, peak device
                memory against the reckoned 45 GB, the last loss below the
                first
  train step, card vs cpu, 2 layers   qwen3-0.6b at full width cut to 2
                layers: the loss and every gradient on the card against the
                CPU's plain path, within the bf16 bounds argued beside them
  driver --arch rwkv6-1.6b        launch/train_svm.py's main with --arch
                rwkv6-1.6b and the CLI's defaults (the reduced backbone, 2000
                documents of 64 tokens, 10 classes; in this process), counts
                reset around it: B1 and B2 launched, no B4, test error below
                chance
  driver --arch deepseek-v2-236b  the same with --arch deepseek-v2-236b: the
                reduced MLA backbone runs B4 at (96, 64) once a layer a batch
                (counted), B1 and B2 launched, test error below chance

Then one JSON line {"kernels": [...]} (``launches_libsvm``: each kernel's
launches summed over the LIBSVM phases; ``launches_shards`` over the two
shard phases; ``launches_trace`` over the traced fit,
``launches_int8_blocks`` over the int8 stage 2, ``launches_block_cache``
over the cached one, ``launches_task_farm`` over the task-farm phases,
``launches_task_farm_workers`` (B2) and ``launches_stage1_workers`` (B1, B3)
a worker of the two-worker runs, ``launches_serving`` (B4) over the serving
phases' prefill steps and encoders, ``launches_serving_by_arch`` (B4)
each configuration's share of it, ``launches_driver_rwkv6`` (B1, B2) over the
rwkv6 driver, ``launches_driver_deepseek`` (B1, B2, B4) over the deepseek
driver, ``shapes`` (B4) its times at each
timed shape, ``launches_table2`` (B1, B2; E1's ``launches``) over
the Table 2 fits, ``launches_train`` (B4) over the training runs) and,
last, the
{"ok": true, ...} line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 on the CUDA
# cores, HBM3 bandwidth, and the dense tensor cores in bf16 (B4, and the
# bf16 passes of B1's and B3's split products).
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12

RAGGED = [(130, 70, 33), (17, 300, 1100), (128, 128, 512), (256, 128, 512)]
GRAM_RTOL = GRAM_ATOL = 2e-4     # fp32 sums in two orders (as tests/test_kernels_pallas.py)
SINGLE_TERM_RTOL = 1e-6          # B1 on rows with one nonzero: its six products' roundings
CANCEL_TOL = 2e-4                # of sum |x||z|, where the sums cancel
# B3 against fp64 at 6281 x 2048 x 784 (tools/b3_probe.py's cases): the SIMT
# B3's largest errors (gram_q8.cu's head note), the bar its per-tile sums meet
B3_FP64_BARS = {"symmetric linear / sum |x||z|": 2.5e-6, "symmetric rbf 1/p": 1.1e-6,
                "cancelling symmetric / sum |x||z|": 8.1e-7,
                "cancelling affine / sum |x||z|": 9.6e-7}
POLISH_W_SHARE = 0.05            # polished w against the cold fit's, of max |w|
POLISH_ERR_DIFF = 0.03           # test error, polished against cold
POLISH_MIN_AGREE = 0.98          # predictions, polished against cold
# predictions, int8 stage-2 blocks against the f32 wire: the lowest share on
# which the f32 fit at tol 1e-2 agrees with one at tol 1e-3 of the same
# problem, over data seeds 0-4 at the streamed path's full width (0.9891-
# 0.9917; int8 against f32 0.9895-0.9917: tools/int8_agreement.py on an
# NVIDIA H100 80GB HBM3, 700 W)
INT8_MIN_AGREE = 0.9891
ALPHA_ATOL = 1e-4                # C = 1 scale
W_RTOL = 1e-3                    # of max |w|
VIOL_RTOL = 1e-3
UNCHANGED_MIN_AGREE = 0.999      # a rounding difference at a clip can flip a counter
DECISION_RTOL = 1e-3             # of max |decision value|
FLASH_TOL = 2e-5                 # fp32: abs and rel, as tests/test_flash_kernel.py
BF16_ULP = 2.0 ** -7             # bf16 outputs: one ulp of the plain value, relative
# bf16 B4, also: flash_attention_rounding_slack, one bf16 step of every p
# within 2^-16 (relative) of a rounding midpoint, times |v|, over l.  The
# kernel's tensor-core logits and ex2 differ from the plain version's in the
# last bits, so such a p may round the other way; the plain version on the
# CPU misses one ulp against itself on the card the same way ("B4 vs plain"
# prints both at S 1000).  The slack is some 0.4% of one ulp of the whole
# p . |v| / l, so a fault in a few rows cannot hide under it.
# ... and such a flip is rare: at most this share of a case's outputs may
# lie beyond one ulp (at most 1.6e-4 on an H100; the plain version with p
# kept in fp32, printed beside it, puts percents of them there).  Not per
# (batch row, query head): one flipped p moves up to D outputs of its row,
# and on an H100 8 of a case's 10 lay in one at S 63, D 64.
BEYOND_ULP_SHARE = 1e-3
SERVE_REL_STEP = 2.0 ** -7      # one bf16 step of a value, relative (serve_logit_tol)
# jamba's prefill against decode, the routes pinned: decode's own top-k may
# leave the prefill's only below this margin, on at most this share of the
# routed tokens (about twice this phase's readings on an H100: margin
# 1.95e-2, 124 of 4096 tokens) ...
JAMBA_FLIP_MARGIN = 0.04
JAMBA_FLIPS = 0.06
# ... and bf16 decode's distance from the fp32 forward at most this times the
# bf16 forward's (GRAD_RATIO of tests/test_torch_train.py); its bf16 forward
# against decode is held at sqrt(sum g_i^2) bf16 steps, each sublayer's
# measured gain g_i under this ceiling (layer 0's output measured 10.414
# steps; a blow-up must not widen the bound it feeds)
JAMBA_DECODE_RATIO = 1.5
GAIN_CEILING = 32.0
LIBRARY_TOL = 3e-2               # SDPA rounds p to bf16: test_flash_bf16's tolerance
FEATURE_ATOL = 0.05              # bf16 end to end, as tests/test_torch_train_svm.py
FEATURE_MEAN_ATOL = 0.005
# Table 2 (baselines/) and training (launch/train.py): the held tolerances
TABLE2_EXACT_MARGIN = 0.04       # LPD-SVM's test error against exact's
                                 # (tests/test_svm_api.py test_close_to_exact_solver)
E1_HELD_EPOCHS = 3
BF16_HALF_STEP = 2.0 ** -8       # one rounding to bf16, relative
GRAD_FP32_DIFF = 1e-3            # of the largest element: two fp32 computations of one
                                 # gradient (dS = P (dP - rowsum P dP) cancels)


@contextlib.contextmanager
def phase(name: str):
    print(f"[{name}] start", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[{name}] ok in {time.perf_counter() - t0:.3f} s", flush=True)


def ragged_params(kind: str, p: int):
    """Kernel parameters scaled to p for randn rows, so that every kind gives
    values of order 0.1-1 that a wrong kernel cannot match: for RBF,
    ||x - z||^2 is about 2p, so gamma = 1/(2p); for poly and tanh, x.z is
    about sqrt(p), so gamma = 1/sqrt(p)."""
    from repro_torch import KernelParams
    gamma = 1.0 / (2 * p) if kind == "rbf" else p ** -0.5
    return KernelParams(kind, gamma=gamma, coef0=0.3, degree=2)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def cuda_ms(fn, reps: int, reset=None) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` runs after one warm-up;
    ``reset`` (untimed) restores the inputs before each run."""
    import torch
    if reset:
        reset()
    fn()
    total = 0.0
    for _ in range(reps):
        if reset:
            reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def cuda_ms_back_to_back(fn, n: int) -> float:
    """Mean CUDA-event time per call over ``n`` back-to-back calls of ``fn``
    after one warm-up: the device's time per call while the host keeps ahead
    of it (``cuda_ms`` times each call alone, the host's launch cost in it)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    ops_ms = flops / peak * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def gram_bound(n: int, m: int, p: int):
    # B1's product as computed: six bf16 passes (piece products of x and z)
    # on the tensor cores; x, z read once, K written once
    return bound_ms(6 * 2.0 * n * m * p, 4.0 * (n * p + m * p + n * m), PEAK_BF16_FLOPS)


def gram_bound_cuda_cores(n: int, m: int, p: int):
    # the same function as one fp32 pass on the CUDA cores (B1's bound before
    # it moved to the tensor cores): the dot products plus the two norm passes
    return bound_ms(2.0 * n * m * p + 2.0 * (n + m) * p, 4.0 * (n * p + m * p + n * m))


def q8_bytes(n: int, m: int, p: int, n_groups: int) -> float:
    # codes once, 8 bytes of table per group, z once, K written once
    return 1.0 * n * p + 8.0 * n_groups + 4.0 * (m * p + n * m)


def gram_q8_bound(n: int, m: int, p: int, n_groups: int):
    # B3's product as computed: three exact bf16 passes (codes times each
    # piece of z) on the tensor cores
    return bound_ms(3 * 2.0 * n * m * p, q8_bytes(n, m, p, n_groups), PEAK_BF16_FLOPS)


def gram_q8_bound_cuda_cores(n: int, m: int, p: int, n_groups: int):
    # the same function as one fp32 pass on the CUDA cores (B3's bound
    # before it moved to the tensor cores): the product, the norm passes,
    # one dequantising FMA per code in each
    return bound_ms(2.0 * n * m * p + 2.0 * (n + m) * p + 2.0 * n * p,
                    q8_bytes(n, m, p, n_groups))


def flash_bound(B: int, S: int, Hq: int, Hkv: int, D: int, dtype, causal: bool = True,
                S_kv: int = None, Dv: int = None):
    """2 B Hq (D + Dv) FLOP per unmasked (q, k) pair (Q K^T at D = Dqk, P V
    at Dv, Dv = D where not given) over the dtype's peak (bf16 tensor cores,
    or fp32), against q (S rows) and k (S_kv rows, S where not given) at
    Dqk, v (S_kv rows) and o (S rows) at Dv, moved once."""
    import torch
    S_kv = S if S_kv is None else S_kv
    Dv = D if Dv is None else Dv
    pairs = S * (S + 1) // 2 if causal else S * S_kv
    esize = 2 if dtype == torch.bfloat16 else 4
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    ops_ms = 2.0 * B * Hq * (D + Dv) * pairs / peak * 1e3
    bytes_ms = esize * (B * S * Hq * (D + Dv) + B * S_kv * Hkv * (D + Dv)) \
        / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def ptxas_entries(log: str, key: str) -> dict:
    """Registers and spilled bytes of each kernel entry whose mangled name
    holds ``key``, from ptxas's log (``-Xptxas -v``)."""
    ptxas, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = found.group(1) if key in found.group(1) else None
            if name:
                ptxas[name] = {}
        elif name and (found := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                          line)):
            ptxas[name]["spills"] = int(found.group(1)) + int(found.group(2))
        elif name and (found := re.search(r"Used (\d+) registers", line)):
            ptxas[name]["registers"] = int(found.group(1))
    return ptxas


def sass_hgmma(lib: Path) -> dict:
    """HGMMA (wgmma) instructions of each function in the SASS of a built
    library (``cuobjdump -sass``), by mangled name."""
    from repro_torch.kernels import build
    sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    hgmma, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
        elif name and "HGMMA" in line:
            hgmma[name] = hgmma.get(name, 0) + 1
    return hgmma


def flash_build_report(log: str, lib: Path, smem_bytes, stages) -> list:
    """B4's instantiations, one a (Dqk, Dv) pair and body: registers and
    spilled bytes from ptxas's log, the dynamic shared memory of a block, the
    bf16 body's ring depth, and the HGMMA (wgmma) instructions in each one's
    SASS."""
    ptxas = ptxas_entries(log, "flash_fwd")
    hgmma = sass_hgmma(lib)
    report = []
    for name, r in ptxas.items():
        tensor_cores = "2tc9flash_fwd" in name
        Dqk, Dv = map(int, re.search(r"ILi(\d+)ELi(\d+)E", name).groups())
        report.append({"body": "bf16, tensor cores" if tensor_cores else "fp32, SIMT",
                       "pair": (Dqk, Dv), "registers": r.get("registers"),
                       "spills": r.get("spills"), "smem": smem_bytes(Dqk, Dv, int(tensor_cores)),
                       "stages": stages(Dqk, Dv) if tensor_cores else None,
                       "hgmma": hgmma.get(name, 0), "tensor_cores": tensor_cores})
    return report


def multiclass_on_card(n: int, p: int, n_classes: int, sep: float, within: float,
                       seed: int, dev):
    """The rows of data.make_multiclass's mixture (a center a class, two
    sub-clusters a class, noise of sd 0.7), drawn in fp32 on the card and
    copied to the host: the same distribution, other draws, in about a second
    where numpy takes half a minute at a million rows."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn(n_classes, p, generator=g, device=dev) * sep
    offs = torch.randn(n_classes, 2, p, generator=g, device=dev) * within
    y = torch.randint(0, n_classes, (n,), generator=g, device=dev)
    sub = torch.randint(0, 2, (n,), generator=g, device=dev)
    x = torch.randn(n, p, generator=g, device=dev).mul_(0.7)
    x += centers[y]
    x += offs[y, sub]
    rows = x.cpu().numpy()
    del x, y, sub
    torch.cuda.empty_cache()
    return rows


def host_free_bytes() -> int:
    """MemAvailable of /proc/meminfo (bytes)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("chip_smoke: no MemAvailable in /proc/meminfo")


def peak_start() -> int:
    """Reset the card's peak-memory count; returns what is allocated now."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_since(base: int) -> int:
    """Peak device memory since ``peak_start`` above its ``base``."""
    import torch
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def serve_logit_tol(n_layers: int, logits, sublayers: int = 2) -> float:
    """The bound on two logit rows of the same token that round differently:
    B4's prefill against decode (B4 rounds p to bf16 before p . v, decode
    keeps it in fp32), or the card's decode against the CPU's (other sums in
    the bf16 products).  Each of a layer's two sublayer outputs (attention,
    FFN) is rounded to bf16 on both sides, and the difference can flip that
    rounding: at most one bf16 step, 2^-7 of the output.  The 2L flips enter
    the residual stream unrelated to each other, so they add in quadrature
    (sqrt(2L) steps of the stream); the final norm and the unembedding carry
    that relative change of the hidden state to every logit, in no
    vocabulary row's direction, so the largest logit error stays within that
    share of the largest logit.  At 2 layers (the reduced models, on the
    CPU) prefill against decode measures half to three quarters of it.  A
    decoder layer with cross-attention has three sublayers (``sublayers``
    3: sqrt(3L) steps)."""
    return math.sqrt(sublayers * n_layers) * SERVE_REL_STEP * logits.abs().max().item()


class PinnedMoE:
    """A MoE model's routing, instrumented to hold its forward against
    teacher-forced decode on one function: every ``_route`` call records its
    ids, router margin (the k-th largest probability less the (k + 1)-th)
    and the pairs ``_bucketize`` kept (``calls``); while ``queue`` holds
    (ids, kept) entries, each call takes the next one in place of its own
    top-k (its weights are the router's own probabilities there,
    renormalised; its aux loss the router's own) and drops the pairs the
    entry did not keep.  Decode's own top-k is still taken, and a flip from
    the pinned route is counted."""

    def __init__(self, cfg, toks, arch: str):
        from repro_torch.models import moe as moe_mod
        self.moe_mod, self.cfg, self.toks, self.arch = moe_mod, cfg, toks, arch
        self.k = cfg.top_k
        self.moe_layers = [i for i in range(cfg.n_layers) if cfg.layer_is_moe(i)]
        self.calls, self.queue, self.now = [], None, None
        self.real_route, self.real_bucketize = moe_mod._route, moe_mod._bucketize

    def route(self, router_w, cfg_, x):
        import torch
        k = self.k
        ids, w, aux = self.real_route(router_w, cfg_, x)
        probs = torch.softmax(x.float() @ router_w, -1)
        top = probs.topk(k + 1, dim=-1).values
        self.calls.append({"ids": ids, "margin": top[:, k - 1] - top[:, k]})
        if self.queue is None:
            return ids, w, aux
        self.now = self.queue.pop(0)
        self.calls[-1]["pinned"] = self.now[0]
        pw = probs.gather(1, self.now[0])
        return self.now[0], pw / pw.sum(-1, keepdim=True), aux

    def bucketize(self, rows, eids, n_buckets, cap):
        import torch
        buf, src = self.real_bucketize(rows, eids, n_buckets, cap)
        n_pairs = rows.shape[0]
        kept = torch.zeros(n_pairs + 1, dtype=torch.bool, device=rows.device)
        kept[torch.where(src >= 0, src.long(), n_pairs).reshape(-1)] = True
        self.calls[-1]["kept"] = kept[:n_pairs].reshape(-1, self.k)
        if self.queue is not None:
            drop = ~self.now[1]
            src = torch.where((src >= 0) & drop[src.long().clamp(min=0)],
                              torch.full_like(src, -1), src)
        return buf, src

    @contextlib.contextmanager
    def patched(self):
        """The instrumented ``_route`` and ``_bucketize`` in place."""
        self.moe_mod._route, self.moe_mod._bucketize = self.route, self.bucketize
        try:
            yield self
        finally:
            self.moe_mod._route = self.real_route
            self.moe_mod._bucketize = self.real_bucketize
            self.queue = self.now = None

    def run(self, mm, routes=None):
        """forward over toks, then S teacher-forced decode steps whose routes
        and kept pairs are the forward's at each position.  ``routes`` (per
        MoE layer (ids, kept), (B, S, k)) pins the forward too; None: its
        own, returned.  Returns (forward's logits, decode's (B, S, Vp) in
        fp32, routes, decode's flips from the forward's routes as (layer,
        row, pos, margin))."""
        import torch
        from repro_torch.models import model as M
        cfg, toks, k = self.cfg, self.toks, self.k
        Bp, Sp = toks.shape
        n_moe = len(self.moe_layers)
        self.calls.clear()
        with self.patched(), torch.no_grad():
            self.queue = None if routes is None else [
                (ids.reshape(-1, k), kept.reshape(-1, k).reshape(-1)) for ids, kept in routes]
            whole = M.forward(mm, cfg, {"tokens": toks})[0].float()
            if routes is None:
                routes = [(c["ids"].reshape(Bp, Sp, k), c["kept"].reshape(Bp, Sp, k))
                          for c in self.calls]
            check(len(self.calls) == n_moe, f"{self.arch}: the MoE layers were not all called")
            state = M.init_decode_state(cfg, Bp, Sp, dtype=mm.embed.dtype,
                                        device=toks.device)
            pos = torch.arange(Sp, device=toks.device)
            dec = []
            for t in range(Sp):
                self.queue = [(ids[:, t], kept[:, t].reshape(-1)) for ids, kept in routes]
                lg, state = M.decode(mm, cfg, toks[:, t:t + 1], state, pos[t])
                dec.append(lg[:, 0].float())
        check(len(self.calls) == n_moe * (1 + Sp),
              f"{self.arch}: a decode step skipped a MoE layer")
        flips = []
        for j in range(n_moe):
            for t in range(Sp):
                c = self.calls[n_moe + t * n_moe + j]
                own = c["ids"].sort(-1).values != c["pinned"].sort(-1).values
                for b in torch.nonzero(own.any(-1)).flatten().tolist():
                    flips.append((self.moe_layers[j], b, t, c["margin"][b].item()))
        return whole, torch.stack(dec, 1), routes, flips


def steps_of(got, want):
    """max |got - want| at each position of each row, in bf16 steps (2^-7)
    of that row's largest |want| logit there: (B, S), on the host."""
    return ((got - want).abs().amax(-1) / (SERVE_REL_STEP * want.abs().amax(-1))).cpu()


def sublayer_gains(m, cfg, toks, pins, seed: int = 5):
    """Each sublayer's gain g_i (2L of them: layer i's mixer, then its FFN):
    the bf16 steps of max|logit| (``steps_of``, the largest over the
    positions) that the logits move when the forward carries one bf16 step
    on the residual stream as that sublayer's add leaves it (x (1 + s
    2^-8) rounded to bf16, s in {-1, 0, 1} at random: one step on about two
    thirds of the elements), the routes and kept pairs pinned to the
    unperturbed forward's.  Returns (gains, the share of elements moved a
    sublayer)."""
    import torch
    from repro_torch.models import blocks
    from repro_torch.models.common import rms_norm
    L, eps = cfg.n_layers, cfg.norm_eps
    pos = torch.arange(toks.shape[1], device=toks.device)
    unembed = m.embed if cfg.tie_embeddings else m.unembed

    def sublayer(j, x, pinned):
        i, half = divmod(j, 2)
        layer = m.layers[i]
        if half == 0:
            return x + blocks._mix_full(layer, cfg, i, rms_norm(x, layer.ln1, eps), pos, True)
        if pinned is not None and i in pinned:
            pins.queue = [pinned[i]]
        return x + blocks._ffn(layer, cfg, i, rms_norm(x, layer.ln2, eps))[0]

    def logits(x):
        return (rms_norm(x, m.final_ln, eps) @ unembed.T).float()

    with pins.patched(), torch.no_grad():
        x, streams, routes = m.embed[toks], [], {}
        for j in range(2 * L):
            pins.calls.clear()
            x = sublayer(j, x, None)
            streams.append(x)
            if j % 2 and cfg.layer_is_moe(j // 2):
                c = pins.calls[0]
                routes[j // 2] = (c["ids"], c["kept"].reshape(-1))
        base = logits(x)
        gains, moved = [], []
        for j in range(2 * L):
            g = torch.Generator(device=x.device).manual_seed(seed + j)
            xa = streams[j]
            sign = torch.randint(-1, 2, xa.shape, generator=g, device=xa.device).float()
            xb = (xa.float() * (1 + sign * 2.0 ** -8)).to(xa.dtype)
            moved.append((xb != xa).float().mean().item())
            for jj in range(j + 1, 2 * L):
                xb = sublayer(jj, xb, routes)
            gains.append(steps_of(logits(xb), base).max().item())
            del xb, sign
    return gains, moved


def serve_phases(dev, smi: str, compare_flash) -> dict:
    """The LM serving path on the card (launch/serve.py, launch/steps.py,
    decode with a KV cache) at full width; returns B4's launches and the
    largest logit errors against their bounds.  ``compare_flash(q, k, v,
    causal, label)`` holds B4 against its plain version (its launches are
    not counted as the path's)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.launch import serve as serving
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import init_model
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.attention import _mla_qkv, _qkv
    from repro_torch.models.common import apply_rotary, rms_norm, rotary_cos_sin

    def teacher_forced(m, cfg, toks, kv_len, state=None):
        """Decode toks (B, S) one position at a time from an empty cache of
        kv_len slots (or from ``state``, an encoder-decoder's with its cross
        k / v): the logits (S, B, Vp) in fp32, and the state."""
        if state is None:
            state = M.init_decode_state(cfg, toks.shape[0], kv_len, device=toks.device)
        pos = torch.arange(toks.shape[1], device=toks.device)
        out = []
        with torch.no_grad():
            for t in range(toks.shape[1]):
                lg, state = M.decode(m, cfg, toks[:, t:t + 1], state, pos[t])
                out.append(lg[:, 0].float())
        return torch.stack(out), state

    def held(got, want, n_layers, label, sublayers=2):
        """got against want (B, Vp), within serve_logit_tol; argmaxes equal
        where want's top-two margin exceeds twice the bound.  Returns (err,
        bound, the line that says so)."""
        check(want.abs().max().item() < 1e29,
              f"{label}: the padded vocabulary's masked logits are in the rows held")
        tol = serve_logit_tol(n_layers, want, sublayers)
        err = (got - want).abs().max().item()
        top2 = torch.topk(want, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
        agree = bool((got.argmax(-1) == want.argmax(-1))[clear].all())
        line = (f"{label}: max abs err {err:.4e} (bound sqrt({sublayers}L) 2^-7 max|logit| "
                f"= {tol:.4e}, {err / tol:.3f} of it); argmax equal on {int(clear.sum())} of "
                f"{want.shape[0]} rows, those of clear margin")
        check(bool(torch.isfinite(got).all()), f"{label}: logits not finite")
        check(err <= tol and agree, f"{line}: disagrees beyond its rounding")
        return err, tol, line

    def worst(results):
        """The result nearest its bound, printed."""
        err, tol, line = max(results, key=lambda r: r[0] / r[1])
        print(line)
        return err, tol

    found = {"b4_launches": {}, "errors": {}}
    with phase("serve, qwen3-0.6b full width"):
        arch, B, P, gen = "qwen3-0.6b", 8, 64, 64
        cfg = get_config(arch)
        L = cfg.n_layers
        check(L == 28 and cfg.d_model == 1024, "qwen3-0.6b is not at its published size")
        base = peak_start()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            tokens = serving.serve(arch, reduced=False, batch=B, prompt_len=P, gen=gen)
        peak = peak_since(base)
        print(out.getvalue(), end="")
        check(tokens.shape == (B, gen) and tokens.dtype == np.int32
              and 0 <= tokens.min() and tokens.max() < cfg.vocab_size,
              "serve's tokens are of the wrong shape or outside the vocabulary")
        print(f"serve {arch} (first call, kv_len {P + gen}): peak device memory {peak} B "
              f"above what was allocated before [{smi}]")
        # the same weights (the same seeded generator) and prompts, warm
        m = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P))
        run = serving.generate(m, cfg, prompts, gen)
        check(np.array_equal(run.tokens, tokens),
              "generate on the rebuilt weights gives other tokens than serve")
        step_ms = 1e3 * (run.seconds - run.prefill_seconds) / gen
        print(f"serve {arch}, B {B}, prompt {P}, gen {gen}, warm: prefill by decode "
              f"{run.prefill_seconds:.4f} s ({1e3 * run.prefill_seconds / P:.3f} ms a step), "
              f"generation {step_ms:.3f} ms a step ({B} tokens), "
              f"{B * (P + gen) / run.seconds:.1f} tok/s incl. prefill [{smi}]")

        toks = torch.as_tensor(prompts, dtype=torch.int32).to(dev)
        prefill = make_prefill_step(cfg)
        flash_attention_kernel.launches = 0
        with torch.no_grad():
            pre = prefill(m, {"tokens": toks}).float()
        torch.cuda.synchronize()
        b4 = flash_attention_kernel.launches
        found["b4_launches"][arch] = b4
        print(f"prefill step (B4): {b4} launches")
        check(b4 == L, "the prefill step did not launch B4 once a layer")
        dec, _ = teacher_forced(m, cfg, toks, P + gen)
        check(torch.equal(dec[-1].argmax(-1).to(torch.int32).cpu(),
                          torch.from_numpy(tokens[:, 0])),
              "decode's argmax at the prompt's end is not serve's first token")
        found["errors"]["prefill " + arch] = worst([held(
            pre, dec[-1], L, f"{arch} prefill step (B4, p in bf16) vs decode at position "
            f"{P - 1}")])
        # 8 teacher-forced steps on the CPU, on a copy of the weights
        cpu_m = init_model(None, cfg, device="cpu")
        cpu_m.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
        t0 = time.perf_counter()
        dec_cpu, _ = teacher_forced(cpu_m, cfg, toks[:, :8].cpu(), P + gen)
        t_cpu = time.perf_counter() - t0
        found["errors"]["card vs cpu " + arch] = worst(
            [held(dec[t].cpu(), dec_cpu[t], L, f"{arch} decode, card vs CPU, the worst of "
                  f"8 steps (pos {t})") for t in range(8)])
        print(f"CPU decode: 8 steps in {t_cpu:.3f} s")
        del cpu_m, dec_cpu
        # the decode step's device time: the profiler's kernel time over 4
        # greedy steps against the unprofiled step's wall from generate
        _, st = teacher_forced(m, cfg, toks[:, :8], P + gen)
        step, pos = make_serve_step(cfg), torch.arange(8, 12, device=dev)
        tok = toks[:, 8:9]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.no_grad():
                for t in range(4):
                    tok, st = step(m, tok, st, pos[t])
            torch.cuda.synchronize()
        # the kernels' own rows (an operator's row repeats its kernels' time)
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                      for e in events) / 1e3 / 4
        kernels_a_step = sum(e.count for e in events) / 4
        if busy_ms > 0:
            found["decode_step"] = {"ms": step_ms, "device_busy_ms": busy_ms,
                                    "kernels": kernels_a_step}
            print(f"decode step (B {B}, kv_len {P + gen}): {step_ms:.3f} ms of wall, "
                  f"{busy_ms:.4f} ms of device kernel time over {kernels_a_step:.0f} "
                  f"kernels (the profiler, 4 steps): device idle share "
                  f"{1 - busy_ms / step_ms:.3f} [{smi}]")
        else:
            print("decode step's device time: not measured (the profiler saw no device time)")
        del st
        # a ring of 32 slots against the full cache of P + gen
        ring, rstate = teacher_forced(m, cfg, toks, 32)
        found["errors"]["ring " + arch] = worst(
            [held(ring[t], dec[t], L, f"{arch} ring W 32 vs full cache, the worst of pos "
                  f"0-31 (pos {t})") for t in range(32)])
        check(bool(torch.isfinite(ring[32:]).all()), "the ring's logits beyond W not finite")
        want_pos = torch.arange(32, 64, device=dev)
        check(all(torch.equal(c["kv"]["pos"], want_pos) for c in rstate),
              "the ring does not hold the last 32 positions")
        print("ring W 32: positions 32-63 finite, the slots hold positions 32-63")
        del m, dec, ring, rstate, pre
        torch.cuda.empty_cache()

    with phase("serve, dense configurations"):
        B, P, n_gen = 4, 64, 8
        # depth cut to hold the smoke run's time (width never): the two
        # 32-layer models at 16 layers
        cut = {"codeqwen1.5-7b": 16, "minitron-4b": 16}
        for arch in ("tinyllama-1.1b", "codeqwen1.5-7b", "minitron-4b"):
            cfg = get_config(arch)
            depth = (f"cut to {cut[arch]} of {cfg.n_layers} layers" if arch in cut
                     else f"{cfg.n_layers} layers (no cut)")
            cfg = dataclasses.replace(cfg, n_layers=cut.get(arch, cfg.n_layers))
            L = cfg.n_layers
            base = peak_start()
            t0 = time.perf_counter()
            m = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
            torch.cuda.synchronize()
            t_init = time.perf_counter() - t0
            n_params = sum(p.numel() for p in m.parameters())
            prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P))
            toks = torch.as_tensor(prompts, dtype=torch.int32).to(dev)
            flash_attention_kernel.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                pre = make_prefill_step(cfg)(m, {"tokens": toks}).float()
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            b4 = flash_attention_kernel.launches
            found["b4_launches"][arch] = b4
            check(b4 == L, f"{arch}: the prefill step did not launch B4 once a layer")
            t0 = time.perf_counter()
            dec, state = teacher_forced(m, cfg, toks, P + n_gen)
            torch.cuda.synchronize()
            t_dec = time.perf_counter() - t0
            found["errors"]["prefill " + arch] = worst([held(
                pre, dec[-1], L, f"{arch} prefill step (B4) vs decode at position {P - 1}")])
            step = make_serve_step(cfg)
            pos = torch.arange(P, P + n_gen, device=dev)
            tok = dec[-1].argmax(-1, keepdim=True).to(torch.int32)
            generated = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                for t in range(n_gen):
                    generated.append(tok)
                    tok, state = step(m, tok, state, pos[t])
                gen_tokens = torch.cat(generated, 1).cpu().numpy()
            t_gen = time.perf_counter() - t0
            peak = peak_since(base)
            check(0 <= gen_tokens.min() and gen_tokens.max() < cfg.vocab_size,
                  f"{arch}: generated tokens outside the vocabulary")
            print(f"{arch}: {depth}, d {cfg.d_model}, heads {cfg.n_heads}/"
                  f"{cfg.n_kv_heads} of {cfg.resolved_head_dim}, {n_params} bf16 parameters "
                  f"in {t_init:.3f} s; prefill step B {B} x {P} {1e3 * t_pre:.3f} ms (first "
                  f"call), {b4} B4 launches; decode {1e3 * t_dec / P:.3f} ms a step over the "
                  f"prompt, {1e3 * t_gen / n_gen:.3f} ms a greedy step; row 0 generates "
                  f"{gen_tokens[0].tolist()}; peak device memory {peak} B [{smi}]")
            del m, dec, state, pre, tok, generated
            torch.cuda.empty_cache()

    def held_b4(q, k, v, causal, label):
        """B4 against its plain version on a layer's own q, k, v; the
        launch is the comparison's, not the path's."""
        n = flash_attention_kernel.launches
        compare_flash(q, k, v, causal, label)
        flash_attention_kernel.launches = n

    def self_qkv(mix, cfg, h):
        """A layer's self-attention q, k, v at positions 0 .. S - 1, rotary
        applied (what gqa_full hands B4)."""
        q, k, v = _qkv(mix, cfg, h)
        cos, sin = rotary_cos_sin(torch.arange(h.shape[1], device=h.device),
                                  cfg.resolved_head_dim, cfg.rope_theta)
        return (apply_rotary(q, cos[None, :, None], sin[None, :, None]),
                apply_rotary(k, cos[None, :, None], sin[None, :, None]), v)

    def serve_seeded(arch, m, B, P, gen):
        """launch/serve.py's serve on the seeded model m: its lines printed,
        its tokens checked and returned with the seconds."""
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            tokens = serving.serve(arch, reduced=False, batch=B, prompt_len=P, gen=gen,
                                   model=m)
        seconds = time.perf_counter() - t0
        print(out.getvalue(), end="")
        check(tokens.shape == (B, gen) and tokens.dtype == np.int32
              and 0 <= tokens.min() and tokens.max() < m.cfg.vocab_size,
              f"{arch}: serve's tokens are of the wrong shape or outside the vocabulary")
        return tokens, seconds

    with phase("serve, phi-3-vision-4.2b full width"):
        # the vision-prefix family: D 96, the config's 576 patch rows ahead
        # of the prompt in the prefill; serving is text only, as the
        # reference's
        arch, B, P, gen = "phi-3-vision-4.2b", 4, 64, 16
        cfg = get_config(arch)
        L, Pn = cfg.n_layers, cfg.num_prefix_embeddings
        check(L == 32 and cfg.d_model == 3072 and cfg.resolved_head_dim == 96 and Pn == 576,
              f"{arch} is not at its published size")
        base = peak_start()
        t0 = time.perf_counter()
        m = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(p.numel() for p in m.parameters())
        tokens, t_serve = serve_seeded(arch, m, B, P, gen)
        prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P))
        toks = torch.as_tensor(prompts, dtype=torch.int32).to(dev)
        prefill = make_prefill_step(cfg)
        flash_attention_kernel.launches = 0
        with torch.no_grad():
            pre = prefill(m, {"tokens": toks}).float()
        torch.cuda.synchronize()
        b4_text = flash_attention_kernel.launches
        check(b4_text == L, f"{arch}: the text prefill did not launch B4 once a layer")
        dec, _ = teacher_forced(m, cfg, toks, P + gen)
        check(torch.equal(dec[-1].argmax(-1).to(torch.int32).cpu(),
                          torch.from_numpy(tokens[:, 0])),
              f"{arch}: decode's argmax at the prompt's end is not serve's first token")
        found["errors"]["prefill " + arch] = worst([held(
            pre, dec[-1], L, f"{arch} prefill step (B4 at D 96) vs decode at position "
            f"{P - 1}")])
        # the prefixed prefill: 576 patch embeddings, then the prompt (S 640)
        g = torch.Generator(device=dev).manual_seed(1)
        prefix = torch.randn(B, Pn, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
        flash_attention_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            pre_x = prefill(m, {"tokens": toks, "prefix": prefix}).float()
        torch.cuda.synchronize()
        t_pre_x = time.perf_counter() - t0
        b4_prefix = flash_attention_kernel.launches
        check(b4_prefix == L, f"{arch}: the prefixed prefill did not launch B4 once a layer")
        check(pre_x.shape == pre.shape and bool(torch.isfinite(pre_x).all()),
              f"{arch}: the prefixed prefill's logits are not finite")
        found["b4_launches"][arch] = b4_text + b4_prefix
        with torch.no_grad():
            x = torch.cat([prefix, m.embed[toks]], 1)
            q, k, v = self_qkv(m.layers[0].mixer, cfg, rms_norm(x, m.layers[0].ln1,
                                                                 cfg.norm_eps))
        held_b4(q, k, v, True, f"{arch} layer 0, prefixed prefill (B {B}, S {Pn + P}, "
                f"{cfg.n_heads}/{cfg.n_kv_heads} heads of 96)")
        del q, k, v, x, dec
        # the prefixed forward at full width cut to 2 layers: the card (B4,
        # cuBLAS) against the CPU's plain path, every position's logits
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        m2 = init_model(torch.Generator(device=dev).manual_seed(0), cfg2, device=dev)
        cpu_m = init_model(None, cfg2, device="cpu")
        cpu_m.load_state_dict({k: v.cpu() for k, v in m2.state_dict().items()})
        batch = {"tokens": toks[:1, :32], "prefix": prefix[:1]}
        t0 = time.perf_counter()
        with torch.no_grad():
            on_card = M.forward(m2, cfg2, batch)[0][0].float().cpu()
            on_cpu = M.forward(cpu_m, cfg2, {k: v.cpu() for k, v in batch.items()})[0][0].float()
        t_cut = time.perf_counter() - t0
        found["errors"]["card vs cpu " + arch] = worst([held(
            on_card, on_cpu, 2, f"{arch} cut to 2 layers, prefixed forward (1 x {Pn} + 32), "
            "card vs CPU, every position")])
        peak = peak_since(base)
        print(f"{arch}: {L} layers (no cut), d {cfg.d_model}, heads {cfg.n_heads}/"
              f"{cfg.n_kv_heads} of {cfg.resolved_head_dim}, {n_params} bf16 parameters in "
              f"{t_init:.3f} s; serve B {B} prompt {P} gen {gen} {t_serve:.3f} s; prefill "
              f"step B {B} x ({Pn} + {P}) {1e3 * t_pre_x:.3f} ms (first call); B4 {b4_text} + "
              f"{b4_prefix} launches (text and prefixed prefill); 2-layer forward card + CPU "
              f"{t_cut:.3f} s; peak device memory {peak} B [{smi}]")
        del m, m2, cpu_m, pre, pre_x, prefix, on_card, on_cpu
        torch.cuda.empty_cache()

    with phase("serve, seamless-m4t-large-v2 full width"):
        # the encoder-decoder family: 24 encoder and 24 decoder layers, the
        # decoder cross-attending the encoder's memory of the config's 1024
        # frames (serve's own loop: 16 frames, as the reference's)
        arch, B, P, gen = "seamless-m4t-large-v2", 4, 64, 16
        cfg = get_config(arch)
        L, Le, F = cfg.n_layers, cfg.n_encoder_layers, cfg.num_prefix_embeddings
        check(L == Le == 24 and cfg.d_model == 1024 and M.padded_vocab(cfg) == 256512
              and F == 1024, f"{arch} is not at its published size")
        base = peak_start()
        t0 = time.perf_counter()
        m = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(p.numel() for p in m.parameters())
        flash_attention_kernel.launches = 0
        tokens, t_serve = serve_seeded(arch, m, B, P, gen)
        b4_serve = flash_attention_kernel.launches
        check(b4_serve == Le, f"{arch}: serve's encoder did not launch B4 once a layer")
        prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P))
        toks = torch.as_tensor(prompts, dtype=torch.int32).to(dev)
        g = torch.Generator(device=dev).manual_seed(2)
        frames = torch.randn(B, F, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
        batch = {"tokens": toks, "frames": frames}
        V = cfg.vocab_size          # the logits past it are the padding, masked
        flash_attention_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            pre = make_prefill_step(cfg)(m, batch)[:, :V].float()
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        b4_pre = flash_attention_kernel.launches
        with torch.no_grad():
            logits = M.forward(m, cfg, batch)[0][..., :V]
            memory = M._run_encoder(m, cfg, frames)
            state = M.prefill_cross_attention(m, cfg, M.init_decode_state(
                cfg, B, P, device=dev, enc_len=F), memory)
        torch.cuda.synchronize()
        b4 = flash_attention_kernel.launches
        check(b4_pre == Le + 2 * L and b4 == 2 * b4_pre + Le,
              f"{arch}: B4 did not run once an encoder layer and twice a decoder layer")
        found["b4_launches"][arch] = b4_serve + b4
        t0 = time.perf_counter()
        dec, _ = teacher_forced(m, cfg, toks, P, state)
        t_dec = time.perf_counter() - t0
        dec = dec[..., :V]
        # the memory is the same on both sides (the same kernels on the same
        # frames); each decoder layer's three sublayers may round apart
        found["errors"]["prefill " + arch] = worst([held(
            pre, dec[-1], L, f"{arch} prefill step (B4, encoder over {F} frames) vs decode "
            f"with the cross cache at position {P - 1}", sublayers=3)])
        found["errors"]["forward " + arch] = worst(
            [held(dec[t], logits[:, t].float(), L, f"{arch} teacher-forced decode with the "
                  f"cross cache vs forward's logits, the worst of {P} positions (pos {t})",
                  sublayers=3) for t in range(P)])
        with torch.no_grad():
            enc0 = m.encoder.layers[0]
            q, k, v = self_qkv(enc0.mixer, cfg, rms_norm(frames, enc0.ln1, cfg.norm_eps))
            held_b4(q, k, v, False, f"{arch} encoder layer 0 (B {B}, S {F}, "
                    f"{cfg.n_heads}/{cfg.n_kv_heads} heads of 64, not causal)")
            cross = m.layers[0].cross
            hx = rms_norm(m.embed[toks], m.layers[0].ln_x, cfg.norm_eps)
            hd = cfg.resolved_head_dim
            q = (hx @ cross.wq).reshape(B, P, cfg.n_heads, hd)
            k = (memory @ cross.wk).reshape(B, F, cfg.n_kv_heads, hd)
            v = (memory @ cross.wv).reshape(B, F, cfg.n_kv_heads, hd)
            held_b4(q, k, v, False, f"{arch} decoder layer 0 cross-attention (B {B}, S {P}, "
                    f"S_kv {F}, not causal)")
        peak = peak_since(base)
        print(f"{arch}: {Le} + {L} layers (no cut), d {cfg.d_model}, heads {cfg.n_heads}/"
              f"{cfg.n_kv_heads} of {cfg.resolved_head_dim}, vocab {cfg.vocab_size} padded "
              f"to {M.padded_vocab(cfg)}, {n_params} bf16 parameters in {t_init:.3f} s; serve "
              f"B {B} prompt {P} gen {gen} (16 frames) {t_serve:.3f} s; prefill step B {B} x "
              f"{P} over {F} frames {1e3 * t_pre:.3f} ms (first call); teacher-forced decode "
              f"{1e3 * t_dec / P:.3f} ms a step; B4 {b4_serve} (serve's encoder) + {b4} "
              f"launches; peak device memory {peak} B [{smi}]")
        del m, pre, logits, memory, state, dec, frames, q, k, v, hx
        torch.cuda.empty_cache()

    # The SSM and MoE families.  An SSM sublayer (RWKV6's time-mix, Mamba)
    # ends, as attention does, in a bf16 product (wo, w_out) whose output is
    # rounded to bf16 on both sides; the chunked form against the
    # recurrence (or the card's sums against the CPU's) differ inside it in
    # fp32, and that can flip the rounding of its output: one bf16 step of
    # the sublayer, as for attention, so serve_logit_tol's sqrt(2L) steps
    # bound rwkv6's logits (its r, k, v, g, w products are fp32).  That
    # bound counts each rounding's reach to the logits as one step: true of
    # the dense stacks and of rwkv6, not of jamba's Mamba layers, whose
    # output multiplies several functions of the input (C, B, dt, the conv
    # and the silu gate), so that one bf16 step on a layer's output reaches
    # the logits several steps wide.  So jamba's bf16 forward against its
    # bf16 decode is held at sqrt(sum g_i^2) steps, g_i each sublayer's
    # measured gain; its decode path is held at sqrt(2L) on the same weights
    # in fp32, and its bf16 decode against the bf16 forward's own distance
    # from that.
    # A MoE FFN is the same function on both sides only where the routes
    # and kept pairs agree: a whole sequence drops pairs for capacity that B
    # decode tokens (below the capacity's floor of 8) never drop, and a
    # near-tie may route apart; decode's routes and kept pairs are pinned to
    # the prefill's, and its own choices counted.
    with phase("serve, rwkv6-1.6b full width"):
        arch, B, P, gen = "rwkv6-1.6b", 4, 32, 32
        cfg = get_config(arch)
        L, V = cfg.n_layers, cfg.vocab_size
        check(L == 24 and cfg.d_model == 2048 and cfg.ssm_kind == "rwkv6"
              and cfg.ssm_head_dim == 64 and V == 65536, f"{arch} is not at its published size")
        base = peak_start()
        t0 = time.perf_counter()
        m = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(p.numel() for p in m.parameters())
        flash_attention_kernel.launches = 0
        tokens, t_serve = serve_seeded(arch, m, B, P, gen)
        prompts = np.random.default_rng(0).integers(0, V, (B, P))
        run = serving.generate(m, cfg, prompts, gen)
        check(np.array_equal(run.tokens, tokens),
              f"{arch}: generate on the same weights gives other tokens than serve")
        step_ms = 1e3 * (run.seconds - run.prefill_seconds) / gen
        # the prefill step at B 4 x S 512 (32 chunks of 16), first call and warm
        g = np.random.default_rng(1)
        toks = torch.as_tensor(g.integers(0, V, (4, 512)), dtype=torch.int32).to(dev)
        prefill = make_prefill_step(cfg)
        pre_ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                pre = prefill(m, {"tokens": toks}).float()
            torch.cuda.synchronize()
            pre_ms.append(1e3 * (time.perf_counter() - t0))
        check(bool(torch.isfinite(pre).all()), f"{arch}: the prefill's logits are not finite")
        check(flash_attention_kernel.launches == 0,
              f"{arch}: an attention-free model launched B4")
        # the chunked form against the recurrence: forward over 64 tokens
        # (4 chunks) against 64 teacher-forced decode steps, every position
        with torch.no_grad():
            whole = M.forward(m, cfg, {"tokens": toks[:, :64]})[0].float()
        dec, state = teacher_forced(m, cfg, toks[:, :64], 64)
        check(all("ssm" in c and "kv" not in c for c in state),
              f"{arch}: a decode cache holds a KV cache")
        found["errors"]["prefill " + arch] = worst(
            [held(dec[t], whole[:, t], L, f"{arch} chunked forward (16-token chunks) vs the "
                  f"decode recurrence, the worst of 64 positions (pos {t})") for t in range(64)])
        del whole, dec, state
        # the card against the CPU at full width cut to 2 layers
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        m2 = init_model(torch.Generator(device=dev).manual_seed(0), cfg2, device=dev)
        cpu_m = init_model(None, cfg2, device="cpu")
        cpu_m.load_state_dict({k: v.cpu() for k, v in m2.state_dict().items()})
        t0 = time.perf_counter()
        with torch.no_grad():
            on_card = M.forward(m2, cfg2, {"tokens": toks[:1, :32]})[0][0].float().cpu()
            on_cpu = M.forward(cpu_m, cfg2, {"tokens": toks[:1, :32].cpu()})[0][0].float()
        t_cut = time.perf_counter() - t0
        found["errors"]["card vs cpu " + arch] = worst([held(
            on_card, on_cpu, 2, f"{arch} cut to 2 layers, forward (1 x 32), card vs CPU, every "
            "position")])
        peak = peak_since(base)
        found["rwkv6"] = {"decode_step_ms": step_ms, "tok_s": B * (P + gen) / run.seconds,
                          "prefill_ms": pre_ms, "peak": peak, "params": n_params}
        print(f"{arch}: {L} layers (no cut), d {cfg.d_model}, {cfg.d_model // 64} heads of 64 "
              f"(RWKV6, no attention), {n_params} parameters ({cfg.param_count()} reckoned) in "
              f"{t_init:.3f} s; serve B {B} prompt {P} gen {gen} {t_serve:.3f} s; warm: "
              f"generation {step_ms:.3f} ms a step, {B * (P + gen) / run.seconds:.1f} tok/s incl. "
              f"prefill by decode; prefill step B 4 x 512 {pre_ms[0]:.3f} ms (first call), "
              f"{pre_ms[1]:.3f} ms (warm); B4 0 launches; 2-layer forward card + CPU "
              f"{t_cut:.3f} s; peak device memory {peak} B [{smi}]")
        del m, m2, cpu_m, pre, on_card, on_cpu
        torch.cuda.empty_cache()

    with phase("serve, jamba-v0.1-52b full width, 8 layers"):
        # one whole group of the layer pattern: Mamba at 0-3 and 5-7,
        # attention at 4, MoE FFNs at 1, 3, 5, 7; all 32 layers (51.45 B
        # parameters, 103 GB in bf16) do not fit on one card
        from repro_torch.models import blocks
        from repro_torch.models import ssm as ssm_mod
        arch = "jamba-v0.1-52b"
        full = get_config(arch)
        check(full.n_layers == 32 and full.d_model == 4096 and full.n_experts == 16
              and full.top_k == 2 and full.n_heads == 32 and full.n_kv_heads == 8
              and full.ssm_kind == "mamba" and full.attn_layer_period == 8,
              f"{arch} is not at its published size")
        cfg = dataclasses.replace(full, n_layers=8)
        L, V, k, E = cfg.n_layers, cfg.vocab_size, cfg.top_k, cfg.n_experts
        moe_layers = [i for i in range(L) if cfg.layer_is_moe(i)]
        n_moe = len(moe_layers)
        attn_layers = [i for i in range(L) if cfg.layer_kind(i) == "attn"]
        print(f"{arch} cut: n_layers 32 -> 8 (one group of the 1-in-8 attention, "
              f"MoE-every-other-layer pattern: attention at {attn_layers}, MoE at "
              f"{moe_layers}); width, heads, experts, vocab as published")
        base = peak_start()
        t0 = time.perf_counter()
        m = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(p.numel() for p in m.parameters())
        # serving: launch/serve.py's loop (generate) at B 4, prompt 32, gen 16
        B, P, gen = 4, 32, 16
        prompts = np.random.default_rng(0).integers(0, V, (B, P))
        flash_attention_kernel.launches = 0
        runs = [serving.generate(m, cfg, prompts, gen) for _ in range(2)]
        check(flash_attention_kernel.launches == 0, f"{arch}: decode launched B4")
        check(np.array_equal(runs[0].tokens, runs[1].tokens)
              and 0 <= runs[0].tokens.min() and runs[0].tokens.max() < V,
              f"{arch}: two greedy runs differ, or a token lies outside the vocabulary")
        run = runs[1]
        step_ms = 1e3 * (run.seconds - run.prefill_seconds) / gen
        # the prefill step at B 2 x S 512 (two Mamba chunks of 256), B4 once
        # an attention layer, counted; first call and warm
        Bp, Sp = 2, 512
        toks = torch.as_tensor(np.random.default_rng(1).integers(0, V, (Bp, Sp)),
                               dtype=torch.int32).to(dev)
        prefill = make_prefill_step(cfg)
        pre_ms = []
        flash_attention_kernel.launches = 0
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                pre = prefill(m, {"tokens": toks}).float()
            torch.cuda.synchronize()
            pre_ms.append(1e3 * (time.perf_counter() - t0))
        b4 = flash_attention_kernel.launches
        found["b4_launches"][arch] = b4
        check(b4 == 2 * len(attn_layers),
              f"{arch}: the prefill step did not launch B4 once an attention layer")
        # Every MoE call's route, router margin and kept pairs are recorded.
        # Decode's routes and kept pairs are pinned to the prefill's at each
        # position (its weights and aux stay the router's own), so that both
        # sides compute one function at all B x S positions; decode's own
        # top-k is still taken, and a flip from the prefill's is counted.
        pins = PinnedMoE(cfg, toks, arch)
        whole, dec, routes, flips = pins.run(m)
        drops = [int((~kept).sum()) for _, kept in routes]
        n_routed = n_moe * Bp * Sp
        print(f"{arch} MoE capacity drops in the B {Bp} x {Sp} prefill (cap "
              f"{moe_mod._capacity(Bp * Sp * k / E, cfg.capacity_factor)} of {Bp * Sp * k} "
              f"pairs over {E} experts): layers {moe_layers} dropped {drops} pairs, each "
              f"dropped by decode too (pinned); decode's own top-{k} left the prefill's on "
              f"{len(flips)} of {n_routed} routed tokens (routes pinned), largest margins "
              + ", ".join(f"{mg:.3e} (layer {i} row {b} pos {t})" for i, b, t, mg in
                          sorted(flips, key=lambda f: f[3])[-4:]))
        check(all(f[3] < JAMBA_FLIP_MARGIN for f in flips)
              and len(flips) <= JAMBA_FLIPS * n_routed,
              f"{arch}: a decode route left the prefill's at a margin of "
              f"{JAMBA_FLIP_MARGIN} or more, or on more than {JAMBA_FLIPS} of the tokens")
        # bf16 prefill against bf16 decode, all B x S positions.  A Mamba
        # layer carries a rounding to the logits many steps wide, so the
        # bound counts each rounding's measured reach: g_i, the gain of
        # sublayer i (one bf16 step on the residual stream its add leaves,
        # carried by the pinned forward to the logits), each held under
        # GAIN_CEILING; the 2L roundings add in quadrature, sqrt(sum g_i^2)
        gains, moved = sublayer_gains(m, cfg, toks, pins)
        gain_bound = math.sqrt(sum(g * g for g in gains))
        d16 = steps_of(dec, whole)
        r16 = d16 / math.sqrt(2 * L)
        bf16_line = (f"{arch} bf16 forward (B {Bp} x {Sp}) vs teacher-forced decode, routes "
                     f"pinned, all {Bp * Sp} positions: max {d16.max().item():.3f} bf16 steps "
                     f"of max|logit| (median {d16.median().item():.3f}) against the bound "
                     f"sqrt(sum g_i^2) = {gain_bound:.3f} ({d16.max().item() / gain_bound:.3f} "
                     f"of it); {r16.max().item():.3f} of sqrt(2L) at worst, "
                     f"{int((r16 > 1).sum())} positions beyond sqrt(2L)")
        print(f"{arch} sublayer gains g_i (layer i's mixer, then its FFN; one bf16 step on "
              f"{min(moved):.3f}-{max(moved):.3f} of the stream's elements, routes pinned), in "
              f"bf16 steps of max|logit|: " + ", ".join(f"{g:.3f}" for g in gains)
              + f" (ceiling {GAIN_CEILING})")
        print(bf16_line)
        check(all(g <= GAIN_CEILING for g in gains),
              f"{arch}: a sublayer's gain exceeds {GAIN_CEILING} bf16 steps")
        check(bool(torch.isfinite(dec).all()) and d16.max().item() <= gain_bound,
              f"{bf16_line}: decode strays from the forward beyond its roundings' reach")
        gain = gains[1]                    # layer 0's output, as earlier runs printed it
        # layer 0's bf16 Mamba products over the whole prefill against one
        # token at a time, as decode runs them: elements that round apart
        with torch.no_grad():
            mix = m.layers[0].mixer
            h = rms_norm(m.embed[toks], m.layers[0].ln1, cfg.norm_eps)
            u = ssm_mod._mamba_scan_inputs(mix, cfg, h)[0].to(h.dtype)
            apart = {}
            for name, a, w in (("w_in", h, mix.w_in), ("w_bcdt", u, mix.w_bcdt),
                               ("w_out", u, mix.w_out)):
                one = torch.cat([a[:, t:t + 1] @ w for t in range(Sp)], 1)
                apart[name] = (one != a @ w).float().mean().item()
            del h, u, one
        print(f"{arch} layer 0's Mamba products at T {Sp} against T 1, the share of "
              f"elements apart: {apart}")
        # B4 on the attention layer's own q, k, v at this shape
        with torch.no_grad():
            x = m.embed[toks]
            pos = torch.arange(Sp, device=dev)
            for i in range(attn_layers[0]):
                x, _ = blocks.apply_layer_full(m.layers[i], cfg, i, x, pos)
            layer = m.layers[attn_layers[0]]
            q, kk, v = self_qkv(layer.mixer, cfg, rms_norm(x, layer.ln1, cfg.norm_eps))
        held_b4(q, kk, v, True, f"{arch} layer {attn_layers[0]}, prefill (B {Bp}, S {Sp}, "
                f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim})")
        peak = peak_since(base)
        del x, q, kk, v
        # The same weights in fp32 (the model cast in place), the bf16
        # prefill's routes and kept pairs pinned on both sides.  Prefill
        # against decode within serve_logit_tol's sqrt(2L) bf16 steps at
        # every position: the decode path's logic (the Mamba state and conv
        # window, the KV cache, the MoE FFN of B tokens) at full width, where
        # each rounding is 2^-16 of a bf16 one.  Then each bf16 path against
        # the fp32 forward: decode no further from it than JAMBA_DECODE_RATIO
        # times the prefill.
        m.float()
        whole32, dec32, _, flips32 = pins.run(m, routes)
        r32 = steps_of(dec32, whole32) / math.sqrt(2 * L)
        d_pre, d_dec = steps_of(whole, whole32), steps_of(dec, whole32)
        print(f"{arch} fp32 twin (the weights cast, the bf16 routes pinned): forward vs "
              f"teacher-forced decode, all {Bp * Sp} positions: max {r32.max().item():.4f} of "
              f"sqrt(2L) 2^-7 max|logit| (decode's own top-{k} left the pin on "
              f"{len(flips32)} tokens); distance from the fp32 forward in bf16 steps of "
              f"max|logit|: bf16 forward max {d_pre.max().item():.3f} median "
              f"{d_pre.median().item():.3f}, bf16 decode max {d_dec.max().item():.3f} median "
              f"{d_dec.median().item():.3f} (limit {JAMBA_DECODE_RATIO} x the forward's "
              f"max) [{smi}]")
        check(bool(torch.isfinite(dec32).all()) and r32.max().item() <= 1,
              f"{arch}: fp32 decode strays from the fp32 forward beyond sqrt(2L) bf16 steps")
        check(d_dec.max().item() <= JAMBA_DECODE_RATIO * d_pre.max().item(),
              f"{arch}: bf16 decode lies further from the fp32 forward than "
              f"{JAMBA_DECODE_RATIO} x the bf16 forward")
        peak32 = peak_since(base)
        found["jamba"] = {"decode_step_ms": step_ms, "tok_s": B * (P + gen) / run.seconds,
                          "prefill_ms": pre_ms, "dropped_pairs": drops, "flips": len(flips),
                          "peak": peak, "peak_fp32": peak32, "params": n_params,
                          "bf16_of_sqrt2L": r16.max().item(), "fp32_of_sqrt2L": r32.max().item(),
                          "gain": gain, "gains": gains, "bf16_of_gain_bound":
                          d16.max().item() / gain_bound, "products_apart": apart}
        print(f"{arch}: 8 of 32 layers, d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} "
              f"of {cfg.resolved_head_dim}, {E} experts top-{k}, {n_params} bf16 parameters in "
              f"{t_init:.3f} s; generate B {B} prompt {P} gen {gen} (warm): prefill by decode "
              f"{run.prefill_seconds:.3f} s, generation {step_ms:.3f} ms a step, "
              f"{B * (P + gen) / run.seconds:.1f} tok/s; prefill step B {Bp} x {Sp} "
              f"{pre_ms[0]:.3f} ms (first call), {pre_ms[1]:.3f} ms (warm); B4 {b4} launches "
              f"(two prefill steps); peak device memory {peak} B in bf16, {peak32} B with "
              f"the fp32 twin [{smi}]")
        del m, pre, whole, dec, whole32, dec32, pins, routes
        torch.cuda.empty_cache()
    # The MLA family and kimi-k2: MoE layers of many experts behind one dense
    # layer, cut in depth only.  Prefill against teacher-forced decode with
    # the routes and kept pairs pinned, as jamba's, within serve_logit_tol's
    # sqrt(2L) bf16 steps: these stacks have no Mamba layer.  deepseek-v2's
    # decode is MLA's absorbed form over the latent cache (per-head k and v
    # never formed, p in fp32), its prefill B4 at (192, 128).
    def serve_moe(arch, n_layers, published, why):
        full = get_config(arch)
        check(published(full), f"{arch} is not at its published size")
        cfg = dataclasses.replace(full, n_layers=n_layers)
        L, V, k, E = cfg.n_layers, cfg.vocab_size, cfg.top_k, cfg.n_experts
        moe_layers = [i for i in range(L) if cfg.layer_is_moe(i)]
        print(f"{arch} cut: n_layers {full.n_layers} -> {L} ({why}); width, heads, "
              f"experts, vocab as published; {cfg.param_count()} parameters "
              f"({2 * cfg.param_count() / 2 ** 30:.1f} GiB in bf16) by param_count")
        base = peak_start()
        t0 = time.perf_counter()
        m = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(p.numel() for p in m.parameters())
        B, P, gen = 2, 512, 32
        prompts = np.random.default_rng(0).integers(0, V, (B, P))
        flash_attention_kernel.launches = 0
        run = serving.generate(m, cfg, prompts, gen)
        check(flash_attention_kernel.launches == 0, f"{arch}: decode launched B4")
        check(run.tokens.shape == (B, gen) and 0 <= run.tokens.min()
              and run.tokens.max() < V, f"{arch}: a generated token lies outside the vocabulary")
        step_ms = 1e3 * (run.seconds - run.prefill_seconds) / gen
        toks = torch.as_tensor(prompts, dtype=torch.int32).to(dev)
        prefill = make_prefill_step(cfg)
        pre_ms = []
        flash_attention_kernel.launches = 0
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                pre = prefill(m, {"tokens": toks}).float()
            torch.cuda.synchronize()
            pre_ms.append(1e3 * (time.perf_counter() - t0))
        b4 = flash_attention_kernel.launches
        found["b4_launches"][arch] = b4
        check(b4 == 2 * L, f"{arch}: the prefill step did not launch B4 once a layer")
        pins = PinnedMoE(cfg, toks, arch)
        whole, dec, routes, flips = pins.run(m)
        drops = [int((~kept).sum()) for _, kept in routes]
        n_routed = len(moe_layers) * B * P
        print(f"{arch} MoE capacity drops in the B {B} x {P} prefill (cap "
              f"{moe_mod._capacity(B * P * k / E, cfg.capacity_factor)} of {B * P * k} pairs "
              f"over {E} experts): layers {moe_layers} dropped {drops} pairs (pinned for "
              f"decode too); decode's own top-{k} left the prefill's on {len(flips)} of "
              f"{n_routed} routed tokens, largest margins "
              + ", ".join(f"{mg:.3e}" for *_, mg in sorted(flips, key=lambda f: f[3])[-4:]))
        check(all(f[3] < JAMBA_FLIP_MARGIN for f in flips),
              f"{arch}: a decode route left the prefill's at a margin of {JAMBA_FLIP_MARGIN}")
        d16 = steps_of(dec, whole)
        r16 = d16 / math.sqrt(2 * L)
        # each sublayer's reach to the logits, printed beside the bound
        gains, _ = sublayer_gains(m, cfg, toks, pins)
        line = (f"{arch} bf16 forward (B {B} x {P}) vs teacher-forced decode, routes pinned, "
                f"all {B * P} positions: max {r16.max().item():.3f}, median "
                f"{r16.median().item():.3f} of sqrt(2L) 2^-7 max|logit| (max "
                f"{d16.max().item():.3f} steps; the sublayers' gains "
                + ", ".join(f"{g:.3f}" for g in gains)
                + f" steps, sqrt(sum g_i^2) {math.sqrt(sum(g * g for g in gains)):.3f})")
        print(line)
        check(bool(torch.isfinite(dec).all()) and r16.max().item() <= 1,
              f"{line}: decode strays from the forward beyond its roundings")
        # B4 on layer 0's own q, k, v at this shape
        with torch.no_grad():
            layer = m.layers[0]
            h = rms_norm(m.embed[toks], layer.ln1, cfg.norm_eps)
            if cfg.attention == "mla":
                q, kk, v = _mla_qkv(layer.mixer, cfg, h, torch.arange(P, device=dev))
                heads = (f"{cfg.n_heads} heads at (Dqk, Dv) ({q.shape[-1]}, {v.shape[-1]}), "
                         "v strided")
            else:
                q, kk, v = self_qkv(layer.mixer, cfg, h)
                heads = f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}"
        held_b4(q, kk, v, True, f"{arch} layer 0, prefill (B {B}, S {P}, {heads})")
        del h, q, kk, v
        peak = peak_since(base)
        res = {"decode_step_ms": step_ms, "tok_s": B * (P + gen) / run.seconds,
               "prefill_ms": pre_ms, "dropped_pairs": drops, "flips": len(flips),
               "peak": peak, "params": n_params, "bf16_of_sqrt2L": r16.max().item(),
               "gains": gains}
        print(f"{arch}: {L} of {full.n_layers} layers, d {cfg.d_model}, heads "
              f"{cfg.n_heads}/{cfg.n_kv_heads}, {E} experts top-{k} + "
              f"{cfg.n_shared_experts} shared, {n_params} bf16 parameters in {t_init:.3f} s; "
              f"generate B {B} prompt {P} gen {gen}: prefill by decode "
              f"{run.prefill_seconds:.3f} s, generation {step_ms:.3f} ms a step, "
              f"{B * (P + gen) / run.seconds:.1f} tok/s; prefill step B {B} x {P} "
              f"{pre_ms[0]:.3f} ms (first call), {pre_ms[1]:.3f} ms (warm); B4 {b4} launches "
              f"(two prefill steps); peak device memory {peak} B [{smi}]")
        del m, pre, whole, dec, pins, routes
        torch.cuda.empty_cache()
        return res

    with phase("serve, deepseek-v2-236b full width, 4 layers"):
        found["deepseek"] = serve_moe(
            "deepseek-v2-236b", 4,
            lambda c: (c.n_layers == 60 and c.d_model == 5120 and c.n_heads == 128
                       and c.attention == "mla" and c.kv_lora_rank == 512
                       and c.q_lora_rank == 1536 and c.rope_head_dim == 64
                       and c.n_experts == 160 and c.top_k == 6 and c.n_shared_experts == 2),
            "the dense layer 0 and MoE layers 1-3: 13.30 B parameters, 24.8 GiB; all 60 "
            "(236 B) do not fit one card")

    with phase("serve, kimi-k2-1t-a32b full width, 2 layers"):
        found["kimi"] = serve_moe(
            "kimi-k2-1t-a32b", 2,
            lambda c: (c.n_layers == 61 and c.d_model == 7168 and c.n_heads == 64
                       and c.n_kv_heads == 8 and c.resolved_head_dim == 112
                       and c.n_experts == 384 and c.top_k == 8 and c.n_shared_experts == 1),
            "the dense layer 0 and MoE layer 1: 19.94 B parameters, 37.1 GiB; three layers "
            "would be 68.9 GiB before any activation")
    return found


def table2_phases(dev, smi: str) -> dict:
    """The paper's Table 2 comparators (baselines/) on the card beside
    LPD-SVM: kernel E1 against its plain version, then a binary and a
    multiclass problem; returns E1's numbers and the launches of B1, B2 and
    E1 over the Table 2 fits."""
    import numpy as np
    import torch
    from repro_torch import LPDSVM, KernelParams, median_gamma
    from repro_torch.baselines import ExactDualSVM, LLSVMStyle, PrimalSGDSVM
    from repro_torch.core.dual_solver import primal_objective
    from repro_torch.data import make_checker, make_multiclass, train_test_split
    from repro_torch.kernels import ops
    from repro_torch.kernels.exact import (exact_epoch_kernel, exact_epoch_plain,
                                           staged_limit)
    from repro_torch.kernels.gram import gram_kernel
    from repro_torch.kernels.smo import smo_epoch_kernel

    counted = {"gram": gram_kernel, "smo_epoch": smo_epoch_kernel,
               "exact_epoch": exact_epoch_kernel}
    found = {"launches": {k: 0 for k in counted}}

    def run(label, name, solver, data, **fit_kw):
        """fit and predict one solver with the counts reset just before and
        read just after; returns (test error, launches)."""
        xtr, ytr, xte, yte = data
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        solver.fit(xtr, ytr, **fit_kw)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        err = solver.error(xte, yte)
        t_pred = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counted.items()}
        for k, v in got.items():
            found["launches"][k] += v
        if isinstance(solver, LPDSVM):
            epochs = f"{int(solver.stats.epochs.max())} (largest of {solver.stats.n_tasks} tasks)"
        elif isinstance(solver, ExactDualSVM):
            epochs = (f"{max(solver.epochs_)} (largest of {len(solver.epochs_)} pairs, "
                      f"{sum(solver.epochs_)} in all)")
        elif isinstance(solver, LLSVMStyle):
            epochs = (f"{solver.epochs_per_chunk} a chunk x "
                      f"{-(-len(xtr) // solver.chunk_size)} chunks")
        else:
            epochs = f"{solver.steps} steps of {solver.batch}"
        print(f"table2 {label} {name}: train {t_fit:.3f} s, predict {t_pred:.3f} s, "
              f"test error {err:.4f}, epochs {epochs}, launches B1 {got['gram']} B2 "
              f"{got['smo_epoch']} E1 {got['exact_epoch']} [{smi}]")
        return err, got

    def pm(y):
        return torch.as_tensor(np.where(y == 0, 1.0, -1.0), dtype=torch.float32, device=dev)

    x, y = make_checker(20000, cells=3, seed=1)
    binary = train_test_split(x, y, 0.3, seed=2)
    kp_bin, C_bin, budget = KernelParams("rbf", gamma=8.0), 16.0, 1024

    with phase("E1 vs plain"):
        # the binary problem's Q from B1, as ExactDualSVM builds it: E1 and
        # its plain version (the reference's step in torch ops, on the card)
        # from alpha 0 for E1_HELD_EPOCHS epochs, equal value for value
        xtr = torch.as_tensor(binary[0], device=dev)
        n = xtr.shape[0]
        yb = pm(binary[1])
        Q = ops.gram(xtr, xtr, kp_bin).mul_(yb[:, None]).mul_(yb[None, :])
        qd = torch.diagonal(Q).clamp(min=1e-12).contiguous()
        a_k = torch.zeros(n, device=dev)
        g_k = torch.ones(n, device=dev)
        a_p, g_p = a_k.clone(), g_k.clone()
        limit = staged_limit()
        print(f"E1: n {n}, Q {Q.numel() * 4} B; grad, alpha, q_diag in shared memory up "
              f"to n {limit}")

        def timed(fn):
            """fn's CUDA-event time (one call alone) and its result"""
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end), out
        e1_err = 0.0
        for e in range(E1_HELD_EPOCHS):
            e1_ms, (vk, mk) = timed(lambda: exact_epoch_kernel(Q, qd, C_bin, a_k, g_k))
            e1_plain, (vp, mp) = timed(lambda: exact_epoch_plain(Q, qd, C_bin, a_p, g_p))
            moved = int(mk)
            same = (torch.equal(a_k, a_p) and torch.equal(g_k, g_p) and torch.equal(vk, vp)
                    and moved == int(mp))
            e1_err = max(e1_err, (a_k - a_p).abs().max().item(),
                         (g_k - g_p).abs().max().item())
            print(f"E1 epoch {e + 1}: viol {float(vk):.6e}, {moved} of {n} steps moved "
                  f"alpha; alpha, grad, viol and moved equal to the plain version's: {same}; "
                  f"E1 {e1_ms:.4f} ms, plain {e1_plain:.1f} ms")
            check(same, f"E1 differs from its plain version at epoch {e + 1}")
        # the bytes the last epoch needs: a row of Q a moving step, q_diag,
        # alpha and grad read, alpha and grad written
        e1_bound, e1_by = bound_ms(0.0, 4.0 * (moved * n + 5 * n))
        # an epoch of still steps only (alpha 0 and C 0: every delta is 0)
        still_ms = cuda_ms(lambda: exact_epoch_kernel(Q, qd, 0.0, torch.zeros_like(a_k),
                                                      g_k.clone()), 3)
        still_ns = 1e6 * still_ms / n
        moving_ns = 1e6 * (e1_ms - still_ms * (n - moved) / n) / moved
        print(f"E1 epoch {E1_HELD_EPOCHS} (n {n}, {moved} moving steps): {e1_ms:.4f} ms "
              f"({1e6 * e1_ms / n:.1f} ns a step), plain {e1_plain:.1f} ms, bound "
              f"{e1_bound:.4f} ms by {e1_by} (the rows it reads at 3.35 TB/s); all of Q "
              f"once {4.0 * n * n / PEAK_HBM_BYTES * 1e3:.4f} ms; an epoch of still "
              f"steps {still_ms:.4f} ms ({still_ns:.1f} ns a step), so a moving step "
              f"{moving_ns:.1f} ns [{smi}]")
        found["e1"] = {"ms": e1_ms, "plain_ms": e1_plain, "bound_ms": e1_bound,
                       "bound_by": e1_by, "max_abs_err": e1_err, "n": n, "moved": moved,
                       "ns_a_step": 1e6 * e1_ms / n, "ns_still_step": still_ns,
                       "ns_moving_step": moving_ns}
        del Q, qd, a_k, g_k, a_p, g_p, xtr
        # a ragged n, and one past the shared-memory limit (grad in global memory)
        for n_r, epochs in ((1000, 3), (limit + 1, 1)):
            g = torch.Generator(device=dev).manual_seed(n_r)
            xr = torch.randn(n_r, 8, generator=g, device=dev)
            yr = torch.where(torch.rand(n_r, generator=g, device=dev) < 0.5, 1.0, -1.0)
            Qr = ops.gram(xr, xr, KernelParams("rbf", gamma=1.0 / 16)).mul_(
                yr[:, None]).mul_(yr[None, :])
            qr = torch.diagonal(Qr).clamp(min=1e-12).contiguous()
            ak, gk = torch.zeros(n_r, device=dev), torch.ones(n_r, device=dev)
            ap, gp = ak.clone(), gk.clone()
            for _ in range(epochs):
                vk, mk = exact_epoch_kernel(Qr, qr, 1.0, ak, gk)
                vp, mp = exact_epoch_plain(Qr, qr, 1.0, ap, gp)
            same = (torch.equal(ak, ap) and torch.equal(gk, gp) and torch.equal(vk, vp)
                    and int(mk) == int(mp))
            print(f"E1 n {n_r} ({'shared' if n_r <= limit else 'global'} memory), "
                  f"{epochs} epoch(s): equal to the plain version's: {same}")
            check(same, f"E1 differs from its plain version at n {n_r}")
            del Qr, qr
        torch.cuda.empty_cache()

    with phase("Table 2, binary"):
        xtr, ytr, xte, yte = binary
        print(f"checker, 3 cells: {len(xtr)} training and {len(xte)} test rows, RBF gamma "
              f"8, C 16, budget {budget}")
        lpd = LPDSVM(kp_bin, C=C_bin, budget=budget, tol=1e-2)
        err_lpd, got = run("binary", "LPD-SVM", lpd, binary)
        check(got["gram"] >= 3 and got["smo_epoch"] > 0 and got["exact_epoch"] == 0,
              "LPD-SVM did not run through B1 and B2")
        ll = LLSVMStyle(kp_bin, C=C_bin, budget=budget, chunk_size=2000)
        err_ll, got = run("binary", "LLSVM", ll, binary)
        chunks = -(-len(xtr) // ll.chunk_size)
        check(got["smo_epoch"] == chunks * ll.epochs_per_chunk and got["gram"] >= 3,
              "LLSVM's chunk epochs did not launch B2 once each")
        sgd = PrimalSGDSVM(kp_bin, C=C_bin, budget=budget, steps=3000)
        err_sgd, got = run("binary", "primal SGD", sgd, binary, factor=lpd.factor)
        check(got["smo_epoch"] == 0 and got["exact_epoch"] == 0 and got["gram"] >= 1,
              "primal SGD launched an SMO kernel or no B1")
        exact = ExactDualSVM(kp_bin, C=C_bin, tol=1e-2)
        base = peak_start()
        err_ex, got = run("binary", "exact", exact, binary)
        peak = peak_since(base)
        check(got["exact_epoch"] == sum(exact.epochs_) > 0 and got["gram"] == 2
              and got["smo_epoch"] == 0,
              "ExactDualSVM did not launch E1 once an epoch, or B1 for K and decisions")
        print(f"exact: {exact.epochs_[0]} epochs (max_epochs {exact.max_epochs}), final "
              f"viol {exact.violations_[0]:.3e} (tol {exact.tol}); LPD-SVM's largest "
              f"violation {float(lpd.stats.violations.max()):.3e} after "
              f"{int(lpd.stats.epochs.max())} epochs, "
              f"peak device memory {peak} B (Q {4 * len(xtr) ** 2} B)")
        tr_lpd, tr_ll = lpd.error(xtr, ytr), ll.error(xtr, ytr)
        n = len(xtr)
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        c = torch.full((n,), C_bin, device=dev)
        p_lpd = float(primal_objective(lpd.factor.G, idx, pm(ytr), c, lpd.W_[0])[0])
        p_sgd = float(primal_objective(lpd.factor.G, idx, pm(ytr), c, sgd.w_)[0])
        print(f"test error: LPD {err_lpd:.4f}, exact {err_ex:.4f} (LPD within "
              f"{TABLE2_EXACT_MARGIN}: {err_lpd <= err_ex + TABLE2_EXACT_MARGIN}), LLSVM "
              f"{err_ll:.4f}, SGD {err_sgd:.4f}; training error LPD {tr_lpd:.4f}, LLSVM "
              f"{tr_ll:.4f}; primal objective on LPD's G: LPD {p_lpd:.6e}, SGD {p_sgd:.6e}")
        check(err_lpd <= err_ex + TABLE2_EXACT_MARGIN,
              "LPD-SVM's test error is not within 0.04 of the exact solver's")
        check(tr_lpd <= tr_ll + 1e-9, "LPD-SVM's training error is worse than LLSVM's")
        check(p_lpd <= p_sgd + 1e-3 * abs(p_sgd),
              "LPD-SVM's primal objective is worse than primal SGD's")
        found["binary"] = {"lpd": err_lpd, "exact": err_ex, "llsvm": err_ll, "sgd": err_sgd}
        del lpd, ll, sgd, exact
        torch.cuda.empty_cache()

    with phase("Table 2, multiclass"):
        x, y = make_multiclass(14000, p=784, n_classes=10, sep=0.07, within=0.06, seed=0)
        multi = train_test_split(x, y, 0.3, seed=2)
        kp = KernelParams("rbf", gamma=median_gamma(multi[0]))
        print(f"the main path's generator: {len(multi[0])} training and {len(multi[2])} "
              f"test rows, p 784, 10 classes, RBF gamma {kp.gamma:.6e}, C 1, budget {budget}")
        lpd = LPDSVM(kp, C=1.0, budget=budget, tol=1e-2)
        err_lpd, got = run("multiclass", "LPD-SVM", lpd, multi)
        check(got["gram"] >= 3 and got["smo_epoch"] > 0, "LPD-SVM did not run B1 and B2")
        exact = ExactDualSVM(kp, C=1.0, tol=1e-2)
        err_ex, got = run("multiclass", "exact", exact, multi)
        check(got["exact_epoch"] == sum(exact.epochs_) > 0 and got["gram"] == 2 * 45,
              "ExactDualSVM did not launch E1 once an epoch, or B1 twice a pair")
        check(max(exact.violations_) < 1e-2, "a pair of ExactDualSVM stopped above tol")
        print(f"test error: LPD {err_lpd:.4f}, exact {err_ex:.4f}")
        check(err_lpd <= err_ex + TABLE2_EXACT_MARGIN,
              "LPD-SVM's test error is not within 0.04 of the exact solver's")
        found["multiclass"] = {"lpd": err_lpd, "exact": err_ex}
        del lpd, exact
        torch.cuda.empty_cache()
    print(f"launches over the Table 2 fits {found['launches']}")
    return found


def train_phases(dev, smi: str) -> dict:
    """The LM training path on the card (launch/train.py, make_train_step,
    B4's autograd Function); returns B4's launches and the measured
    numbers."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_token_batches
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention_grad_plain,
                                                     flash_attention_kernel,
                                                     flash_attention_plain)
    from repro_torch.launch import train as training
    from repro_torch.models import init_model
    from repro_torch.models import model as M

    found = {"b4_launches": {}}

    with phase("B4 gradient vs plain autograd"):
        # the Function's forward is B4, its backward the unrounded attention
        # recomputed block by block; against autograd through the plain
        # version in fp32 (p not rounded) on the same bf16 values.  Bound:
        # the Function's gradient is its fp32 gradient (held equal to
        # flash_attention_grad_plain on the fp32 values) rounded once to
        # bf16, half a step: at most 2^-8 of the tensor's largest element;
        # plus the difference of the two fp32 computations of the same
        # gradient (the analytic block backward against autograd's chain
        # through the online softmax), measured and held under
        # GRAD_FP32_DIFF of the largest element
        worst = 0.0
        for B, S, Hq, Hkv, D in ((32, 256, 16, 8, 128), (8, 256, 32, 4, 64)):
            g = torch.Generator(device=dev).manual_seed(B + D)
            q, k, v = (torch.randn(B, S, h, D, generator=g, device=dev).to(torch.bfloat16)
                       for h in (Hq, Hkv, Hkv))
            dout = torch.randn(B, S, Hq, D, generator=g, device=dev).to(torch.bfloat16)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            before = flash_attention_kernel.launches
            out = ops.flash_attention(*leaves, causal=True)
            got = torch.autograd.grad(out, leaves, dout)
            check(flash_attention_kernel.launches == before + 1,
                  "the Function's forward did not launch B4 once")
            ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
            ref = flash_attention_plain(*ref_leaves, causal=True)
            want = torch.autograd.grad(ref, ref_leaves, dout.float())
            # the Function's own fp32 gradient, before its one rounding
            f32 = flash_attention_grad_plain(q.float(), k.float(), v.float(), dout.float())
            line = []
            for name, a, f, b in zip("qkv", got, f32, want):
                scale = b.abs().max()
                delta = ((f - b).abs().max() / scale).item()
                rel = ((a.float() - b).abs().max() / scale).item()
                lim = BF16_HALF_STEP + delta * (1 + BF16_HALF_STEP)
                worst = max(worst, rel / lim)
                line.append(f"d{name} max rel err {rel:.3e} (fp32 difference {delta:.2e}, "
                            f"{rel / lim:.3f} of the bound)")
                check(torch.equal(a, f.to(torch.bfloat16)),
                      f"B4's gradient d{name} is not its fp32 gradient rounded once")
                check(delta <= GRAD_FP32_DIFF and rel <= lim,
                      f"B4's gradient d{name} strays from autograd's at D {D}")
            bwd_ms = cuda_ms(lambda: flash_attention_grad_plain(q, k, v, dout), 3)
            fwd_ms = cuda_ms(lambda: flash_attention_kernel(q, k, v), 10)
            found.setdefault("grad_ms", {})[f"D{D}"] = {"forward_ms": fwd_ms,
                                                       "backward_plain_ms": bwd_ms}
            print(f"B4 Function, B {B} S {S} {Hq}/{Hkv} heads of {D}: {'; '.join(line)} "
                  f"(relative to the largest |ref|; bound 2^-8 + the fp32 difference); "
                  f"forward (B4) "
                  f"{fwd_ms:.4f} ms, backward (plain recompute) {bwd_ms:.4f} ms [{smi}]")
            del q, k, v, dout, leaves, out, got, ref_leaves, ref, want
        found["grad_worst"] = worst
        torch.cuda.empty_cache()

    def run(arch, steps, batch, seq):
        cfg = get_config(arch)
        n_params = cfg.param_count()
        V = cfg.vocab_size
        rows = seq + (cfg.num_prefix_embeddings if cfg.modality == "vision" else 0)
        layers = (f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers"
                  if cfg.is_encoder_decoder else f"{cfg.n_layers} layers")
        n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
        mixer = (f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim}" if n_attn
                 else f"{cfg.ssm_kind} mixers, {cfg.d_model // cfg.ssm_head_dim} heads of "
                 f"{cfg.ssm_head_dim}, no attention")
        print(f"{arch}: {layers} (no cut), d {cfg.d_model}, {mixer}; memory reckoned: "
              f"parameters {2 * n_params / 1e9:.2f} GB bf16, gradients "
              f"{2 * n_params / 1e9:.2f} GB, AdamW m and v {8 * n_params / 1e9:.2f} GB "
              f"fp32, logits {4 * batch * rows * V / 1e9:.2f} GB fp32")
        base = peak_start()
        flash_attention_kernel.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            losses = training.train(arch, reduced=False, steps=steps, batch=batch, seq=seq,
                                    log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = peak_since(base)
        b4 = flash_attention_kernel.launches
        # a step runs each attention twice (the forward and the remat
        # recompute): a decoder layer's self- and cross-attention, an
        # encoder layer's self-attention (an attention-free model: none)
        per_step = 2 * (n_attn * (2 if cfg.is_encoder_decoder else 1)
                        + cfg.n_encoder_layers)
        print(out.getvalue(), end="")
        # train prints its tok/s since the loop began after every step: the
        # seconds to the end of step s are (s + 1) B S / tok/s
        tok_s = [float(t.replace(",", "")) for t in re.findall(r"tok/s ([\d,]+)",
                                                               out.getvalue())]
        ends = [(i + 1) * batch * seq / t for i, t in enumerate(tok_s)]
        first_ms = 1e3 * ends[0]
        step_ms = 1e3 * (ends[-1] - ends[0]) / (steps - 1)
        print(f"train {arch} B {batch} S {seq}, {steps} steps: first loss {losses[0]:.4f}, "
              f"last {losses[-1]:.4f}; {step_ms:.3f} ms a step after the first "
              f"({1e3 * batch * seq / step_ms:.0f} tok/s; the first {first_ms:.1f} ms), "
              f"wall {wall:.3f} s with the model's init; peak device memory {peak} B; B4 "
              f"{b4} launches ({per_step} a step expected: the forward and the "
              f"recompute) [{smi}]")
        check(len(losses) == steps and all(np.isfinite(losses)), f"{arch}: a loss not finite")
        check(b4 == per_step * steps,
              f"{arch}: B4 did not run twice an attention a step (forward and recompute)")
        if per_step:
            found["b4_launches"][arch] = b4
        torch.cuda.empty_cache()
        return losses, step_ms, first_ms, peak

    with phase("train, qwen3-0.6b full width"):
        losses, step_ms, first_ms, peak = run("qwen3-0.6b", 20, 8, 256)
        check(losses[-1] < losses[0], "qwen3-0.6b: the last loss is not below the first")
        found["qwen3"] = {"first": losses[0], "last": losses[-1], "step_ms": step_ms,
                          "first_step_ms": first_ms, "peak": peak}

    with phase("train step profile, qwen3-0.6b"):
        # where a full-width step's time goes: the profiler's kernel rows
        # over one step after a warm one, against the step's wall (reading
        # the rows of each profiled step's ~15000 kernels takes seconds)
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim import cosine_schedule, get_optimizer
        cfg = get_config("qwen3-0.6b")
        m = init_model(torch.Generator(device=dev).manual_seed(0), cfg)
        opt = get_optimizer("adamw", lr=3e-4, schedule=cosine_schedule(3e-4, 2, 20))
        state = opt.init(dict(m.named_parameters()))
        step = make_train_step(cfg, opt)
        it = synthetic_token_batches(cfg.vocab_size, 8, 256, seed=0)
        batches = [{k: torch.as_tensor(a).to(dev) for k, a in zip(("tokens", "targets"),
                                                                  next(it))}
                   for _ in range(2)]
        m, state, _ = step(m, state, batches[0])
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            m, state, _ = step(m, state, batches[1])
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        rows = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]

        def dev_ms(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0)) / 1e3
        busy = sum(dev_ms(e) for e in rows)
        if busy > 0:
            top = sorted(rows, key=dev_ms, reverse=True)[:6]
            b4 = sum(dev_ms(e) for e in rows if "flash" in e.key)
            print(f"qwen3-0.6b train step (B 8, S 256), profiled: {wall_ms:.3f} ms of wall "
                  f"(profiler on), {busy:.3f} ms of device kernel time over "
                  f"{sum(e.count for e in rows)} kernels a step: device idle share "
                  f"{1 - busy / wall_ms:.3f}; B4 {b4:.3f} ms; the largest: "
                  + "; ".join(f"{e.key[:48]} {dev_ms(e):.3f} ms" for e in top) + f" [{smi}]")
            found["qwen3_profile"] = {"wall_ms": wall_ms, "device_ms": busy, "b4_ms": b4,
                                      "kernels": sum(e.count for e in rows)}
        else:
            print("train step's device time: not measured (the profiler saw no device time)")
        del m, state, step, batches, prof
        torch.cuda.empty_cache()

    with phase("train, tinyllama-1.1b full width"):
        losses, step_ms, first_ms, peak = run("tinyllama-1.1b", 3, 8, 256)
        found["tinyllama"] = {"first": losses[0], "last": losses[-1], "step_ms": step_ms,
                              "first_step_ms": first_ms, "peak": peak}

    with phase("train, phi-3-vision-4.2b full width"):
        # the config's 576 patch rows ahead of 64 tokens (S 640), the loss over
        # the tokens; B4 at D 96 in the forward and the recompute
        losses, step_ms, first_ms, peak = run("phi-3-vision-4.2b", 3, 2, 64)
        check(losses[-1] < losses[0], "phi-3-vision-4.2b: the last loss is not below the first")
        found["phi3"] = {"first": losses[0], "last": losses[-1], "step_ms": step_ms,
                         "first_step_ms": first_ms, "peak": peak}

    with phase("train, seamless-m4t-large-v2 full width"):
        # 32 frames a row through the encoder, its gradient through every
        # decoder layer's cross-attention (B4 over S_kv 32)
        losses, step_ms, first_ms, peak = run("seamless-m4t-large-v2", 3, 4, 64)
        check(losses[-1] < losses[0],
              "seamless-m4t-large-v2: the last loss is not below the first")
        found["seamless"] = {"first": losses[0], "last": losses[-1], "step_ms": step_ms,
                             "first_step_ms": first_ms, "peak": peak}

    with phase("train, rwkv6-1.6b full width"):
        # 24 RWKV6 layers: the chunked time-mix (16-token chunks) in the
        # forward and each layer's recompute, no attention; the fp32 leaves
        # (decay_base, bonus, mix_rkvg) and their AdamW state stay fp32
        losses, step_ms, first_ms, peak = run("rwkv6-1.6b", 3, 4, 256)
        check(losses[-1] < losses[0], "rwkv6-1.6b: the last loss is not below the first")
        found["rwkv6"] = {"first": losses[0], "last": losses[-1], "step_ms": step_ms,
                          "first_step_ms": first_ms, "peak": peak}

    with phase("train, jamba-v0.1-52b full width, 2 layers"):
        # layer 0 (Mamba + dense FFN) and layer 1 (Mamba + MoE, 16 experts of
        # 14336), 3.73 B parameters: with bf16 gradients and AdamW's fp32 m
        # and v about 45 GB (4 layers, 6.93 B, would need 83 GB); B 2, S 256
        # (one Mamba chunk, its per-token scan under a checkpoint of its own)
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim import cosine_schedule, get_optimizer
        arch = "jamba-v0.1-52b"
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        batch, seq, steps = 2, 256, 3
        n_params = cfg.param_count()
        print(f"{arch} cut: n_layers 32 -> 2 (layer 0 Mamba + dense FFN, layer 1 Mamba + MoE "
              f"FFN); memory reckoned: parameters {2 * n_params / 1e9:.2f} GB bf16, gradients "
              f"{2 * n_params / 1e9:.2f} GB, AdamW m and v {8 * n_params / 1e9:.2f} GB fp32, "
              f"AdamW's fp32 temporaries of the largest leaf (16 x 4096 x 14336) "
              f"{4 * 16 * 4096 * 14336 / 1e9:.2f} GB each")
        base = peak_start()
        flash_attention_kernel.launches = 0
        t0 = time.perf_counter()
        m = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        opt = get_optimizer("adamw", lr=3e-4, schedule=cosine_schedule(3e-4, steps // 10, steps))
        state = opt.init(dict(m.named_parameters()))
        fp32 = sorted(n for n, p in m.named_parameters() if p.dtype == torch.float32)
        want = sorted([f"layers.{i}.mixer.{leaf}" for i in range(2) if cfg.layer_kind(i) == "ssm"
                       for leaf in ("a_log", "d_skip", "dt_bias")]
                      + [f"layers.{i}.ffn.router" for i in range(2) if cfg.layer_is_moe(i)])
        check(fp32 == want and len(want) == 7
              and all(state.inner[j][n].dtype == torch.float32 for j in (0, 1) for n in fp32),
              f"{arch}: the fp32 leaves or their AdamW state are not fp32")
        step = make_train_step(cfg, opt)
        it = synthetic_token_batches(cfg.vocab_size, batch, seq, seed=0)
        losses, auxes, step_s = [], [], []
        for _ in range(steps):
            t, y = next(it)
            b = {"tokens": torch.as_tensor(t).to(dev), "targets": torch.as_tensor(y).to(dev)}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m, state, met = step(m, state, b)
            losses.append(float(met["loss"]))
            auxes.append(float(met["aux"]))
            step_s.append(time.perf_counter() - t1)
        wall = time.perf_counter() - t0
        peak = peak_since(base)
        b4 = flash_attention_kernel.launches
        print(f"train {arch} (2 layers) B {batch} S {seq}, {steps} steps: losses "
              f"{[round(v, 4) for v in losses]}, aux {[round(v, 4) for v in auxes]}; step "
              f"seconds {[round(v, 3) for v in step_s]} ({batch * seq / step_s[-1]:.0f} tok/s "
              f"at the last); wall {wall:.3f} s with the model's init; peak device memory "
              f"{peak} B; B4 {b4} launches (no attention layer in the cut) [{smi}]")
        check(all(np.isfinite(losses)) and all(np.isfinite(auxes)) and min(auxes) > 0,
              f"{arch}: a loss or aux not finite, or no aux")
        check(losses[-1] < losses[0], f"{arch}: the last loss is not below the first")
        check(b4 == 0, f"{arch}: the 2-layer cut launched B4")
        found["jamba"] = {"losses": losses, "aux": auxes, "step_s": step_s, "peak": peak}
        del m, state, step, opt
        torch.cuda.empty_cache()

    def train_first_layer(arch):
        """make_train_step on the configuration's dense first layer at full
        width with its own optimizer, B 2, S 256, 3 steps; B4 twice a step
        (the forward and the remat recompute)."""
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim import cosine_schedule, get_optimizer
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=1)
        check(not cfg.layer_is_moe(0), f"{arch}: layer 0 is not its dense layer")
        batch, seq, steps = 2, 256, 3
        n = cfg.param_count()
        state_gb = (8 * n if cfg.optimizer == "adamw" else 0) / 1e9
        lead = max(cfg.vocab_size * cfg.d_model, cfg.d_model * cfg.d_ff)
        two = dataclasses.replace(full, n_layers=2).param_count()
        print(f"{arch} cut: n_layers {full.n_layers} -> 1 (its dense first layer: "
              f"{cfg.attention} attention, d_ff {cfg.d_ff}); memory reckoned: parameters "
              f"{2 * n / 1e9:.2f} GB bf16, gradients {2 * n / 1e9:.2f} GB, {cfg.optimizer} "
              f"state {state_gb:.2f} GB fp32 (Adafactor's factored rows and columns: under "
              f"0.1 GB), the update's fp32 temporaries of the largest leaf "
              f"{4 * lead / 1e9:.2f} GB each; 2 layers would be {two / 1e9:.2f} B parameters")
        base = peak_start()
        flash_attention_kernel.launches = 0
        t0 = time.perf_counter()
        m = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        opt = get_optimizer(cfg.optimizer, lr=3e-4, schedule=cosine_schedule(3e-4, 0, steps))
        state = opt.init(dict(m.named_parameters()))
        step = make_train_step(cfg, opt)
        it = synthetic_token_batches(cfg.vocab_size, batch, seq, seed=0)
        losses, step_s = [], []
        for _ in range(steps):
            t, y = next(it)
            b = {"tokens": torch.as_tensor(t).to(dev), "targets": torch.as_tensor(y).to(dev)}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m, state, met = step(m, state, b)
            losses.append(float(met["loss"]))
            step_s.append(time.perf_counter() - t1)
        wall = time.perf_counter() - t0
        peak = peak_since(base)
        b4 = flash_attention_kernel.launches
        print(f"train {arch} (1 layer) B {batch} S {seq}, {steps} steps, {cfg.optimizer}: "
              f"losses {[round(v, 4) for v in losses]}; step seconds "
              f"{[round(v, 3) for v in step_s]} ({batch * seq / step_s[-1]:.0f} tok/s at the "
              f"last); wall {wall:.3f} s with the model's init; peak device memory {peak} B "
              f"({n} parameters); B4 {b4} launches (2 a step expected) [{smi}]")
        check(all(np.isfinite(losses)), f"{arch}: a loss not finite")
        check(losses[-1] < losses[0], f"{arch}: the last loss is not below the first")
        check(b4 == 2 * steps, f"{arch}: B4 did not run twice a step")
        found["b4_launches"][arch] = b4
        del m, state, step, opt
        torch.cuda.empty_cache()
        return {"losses": losses, "step_s": step_s, "peak": peak, "params": n}

    with phase("train, deepseek-v2-236b full width, 1 layer"):
        # MLA (B4 at (192, 128) in the forward and the recompute) and the
        # dense FFN of 12288; 2 layers (5.36 B parameters) would need 64.3 GB
        # of weights, gradients and AdamW state before any activation
        found["deepseek"] = train_first_layer("deepseek-v2-236b")

    with phase("train, kimi-k2-1t-a32b full width, 1 layer"):
        # GQA at 64 / 8 heads of 112 and the dense FFN of 18432, Adafactor;
        # 2 layers (19.9 B parameters) would need 80 GB in weights and
        # gradients alone
        found["kimi"] = train_first_layer("kimi-k2-1t-a32b")

    with phase("train step, card vs cpu, 2 layers"):
        # qwen3-0.6b at full width cut to 2 layers: one step's loss and every
        # gradient on the card (B4 forward, bf16 products on the tensor
        # cores) against the CPU's (plain versions).  Bounds: each of a
        # layer's two sublayer outputs is rounded to bf16 on both sides, and
        # the difference can flip that rounding, one bf16 step (2^-7);
        # the 2L flips of the forward add in quadrature (serve_logit_tol) and
        # the loss moves by at most twice its logits' error; the backward
        # passes the same 2L sublayers and rounds each gradient again, so a
        # gradient moves by sqrt(4L) steps of its tensor's largest element
        cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2)
        m = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        cpu_m = init_model(None, cfg, device="cpu")
        cpu_m.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
        t, y = next(synthetic_token_batches(cfg.vocab_size, 2, 64, seed=0))
        res = {}
        for where, model in (("card", m), ("cpu", cpu_m)):
            model.requires_grad_(True)
            d = model.embed.device
            t0 = time.perf_counter()
            logits, aux = M.forward(model, cfg, {"tokens": torch.as_tensor(t).to(d)},
                                    remat=True)
            loss = M.lm_loss(logits, torch.as_tensor(y).to(d))
            grads = torch.autograd.grad(loss, list(model.parameters()))
            res[where] = (float(loss.detach()), [g.float().cpu() for g in grads],
                          logits.float().cpu(), time.perf_counter() - t0)
            del logits, grads
        names = [n for n, _ in m.named_parameters()]
        loss_tol = 2 * serve_logit_tol(cfg.n_layers, res["cpu"][2])
        d_loss = abs(res["card"][0] - res["cpu"][0])
        grad_bound = math.sqrt(4 * cfg.n_layers) * SERVE_REL_STEP
        ratios = {}
        for name, a, b in zip(names, res["card"][1], res["cpu"][1]):
            ratios[name] = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        worst = max(ratios, key=ratios.get)
        print(f"2-layer qwen3-0.6b (d 1024, vocab 151936), B 2 S 64: loss card "
              f"{res['card'][0]:.6f}, cpu {res['cpu'][0]:.6f}, |diff| {d_loss:.3e} (bound "
              f"{loss_tol:.3e}, {d_loss / loss_tol:.3f} of it); gradients: the largest "
              f"relative error {ratios[worst]:.3e} ({worst}; bound sqrt(4L) 2^-7 = "
              f"{grad_bound:.4f}, {ratios[worst] / grad_bound:.3f} of it); card "
              f"{res['card'][3]:.3f} s, cpu {res['cpu'][3]:.3f} s")
        check(d_loss <= loss_tol, "the card's loss strays from the CPU's")
        check(ratios[worst] <= grad_bound, "a gradient on the card strays from the CPU's")
        found["card_vs_cpu"] = {"loss": d_loss / loss_tol, "grad": ratios[worst] / grad_bound}
        del m, cpu_m, res
        torch.cuda.empty_cache()
    return found


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch import LPDSVM, KernelParams, SolverConfig, StreamConfig, median_gamma
    from repro_torch.convert import tasks_from_reference
    from repro_torch.core import block_cache, cv, dual_solver, faults, solver_stream
    from repro_torch.core.ovo import build_ovo_tasks
    from repro_torch.core.compact import solve_compact
    from repro_torch.core.nystrom import compute_factor, select_landmarks
    from repro_torch.core.quant import dequant_rows, quantize_rows
    from repro_torch.core.solver_stream import (_row_sq, block_windows,
                                                solve_batch_streamed)
    from repro_torch.core.streaming import (auto_chunk_rows,
                                            compute_factor_streamed,
                                            compute_factor_streamed_csr,
                                            host_buffer)
    from repro_torch.data import BadRowError, make_multiclass, read_libsvm, write_libsvm
    from repro_torch.kernels import build
    from repro_torch.kernels.gram import (gram_kernel, gram_plain,
                                          gram_q8_kernel, gram_q8_plain,
                                          split_bf16x3, split_bf16x3_kernel)
    from repro_torch.kernels.smo import ring_stages, smo_epoch_kernel, smo_epoch_plain
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import HEAD_DIMS as FLASH_PAIRS
    from repro_torch.kernels.flash_attention import (bf16_kv_tile, flash_attention_kernel,
                                                     flash_attention_plain,
                                                     flash_attention_rounding_slack)
    from repro_torch.launch import train_svm as driver
    from repro_torch.launch.train_svm import class_conditioned_tokens, extract_features
    from repro_torch.models import init_model
    from repro_torch.models.model import trunk

    dev = torch.device("cuda")

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout.strip()
        print(smi.splitlines()[0])
        print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
              f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
        torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full fp32
        torch.backends.cudnn.allow_tf32 = False

    with phase("build"):
        logs = build.build_all()
        for log in logs.values():
            print(log)
        b4_lib = build.load("flash_attention")
        b4_build = flash_build_report(logs["flash_attention"],
                                      build.library_path("flash_attention"),
                                      b4_lib.flash_attention_smem_bytes,
                                      b4_lib.flash_attention_bf16_stages)
        for r in b4_build:
            ring = f", a ring of {r['stages']} stages" if r["tensor_cores"] else ""
            print(f"B4 {r['body']} (Dqk, Dv)={r['pair']}: {r['registers']} registers, "
                  f"{r['spills']} bytes spilled, {r['smem']} B of dynamic shared memory{ring}, "
                  f"{r['hgmma']} HGMMA in its SASS")
        check(len(b4_build) == 2 * len(FLASH_PAIRS)
              and sorted({r["pair"] for r in b4_build}) == sorted(FLASH_PAIRS),
              "B4's ptxas report is missing from the build log")
        check(all(r["spills"] == 0 for r in b4_build), "B4 spills registers")
        check(all(r["hgmma"] > 0 for r in b4_build if r["tensor_cores"]),
              "B4's bf16 body has no HGMMA: it does not run on the tensor cores")
        kv_tile = bf16_kv_tile()
        print(f"B4's bf16 kv tile: {kv_tile}")
        b1_build = ptxas_entries(logs["gram"], "gram_tc")
        b1_build.update(ptxas_entries(logs["gram"], "prepass"))
        b1_hgmma = sass_hgmma(build.library_path("gram"))
        for name, r in sorted(b1_build.items()):
            print(f"B1 {name}: {r.get('registers')} registers, {r.get('spills')} bytes "
                  f"spilled, {b1_hgmma.get(name, 0)} HGMMA in its SASS")
        b1_main = [name for name in b1_build if "gram_tc" in name]
        check(len(b1_main) == 4 and len(b1_build) > 4
              and all(r.get("spills") is not None for r in b1_build.values()),
              "B1's ptxas report is missing from the build log")
        check(all(r["spills"] == 0 for r in b1_build.values()), "B1 spills registers")
        check(all(b1_hgmma.get(name, 0) > 0 for name in b1_main),
              "B1 has no HGMMA: it does not run on the tensor cores")
        b3_build = ptxas_entries(logs["gram_q8"], "gram_q8")
        b3_build.update(ptxas_entries(logs["gram_q8"], "prepass"))
        b3_hgmma = sass_hgmma(build.library_path("gram_q8"))
        for name, r in sorted(b3_build.items()):
            print(f"B3 {name}: {r.get('registers')} registers, {r.get('spills')} bytes "
                  f"spilled, {b3_hgmma.get(name, 0)} HGMMA in its SASS")
        b3_main = [name for name in b3_build if "gram_q8_tc" in name]
        check(len(b3_main) == 2 and len(b3_build) > 2
              and all(r.get("spills") is not None for r in b3_build.values()),
              "B3's ptxas report is missing from the build log")
        check(all(r["spills"] == 0 for r in b3_build.values()), "B3 spills registers")
        check(all(b3_hgmma.get(name, 0) > 0 for name in b3_main),
              "B3 has no HGMMA: it does not run on the tensor cores")
        b2_build = {tuple(map(int, re.search(r"smo_epochILi(\d+)ELi(\d+)E", name).groups())): r
                    for name, r in ptxas_entries(logs["smo"], "smo_epoch").items()}
        for (depth, cols), r in sorted(b2_build.items()):
            where = (f"w and {cols} columns a thread in registers" if cols
                     else "w in shared memory")
            print(f"B2, ring of {depth} stages, {where}: {r.get('registers')} "
                  f"registers, {r.get('spills')} bytes spilled")
        check(len(b2_build) > 0 and all(r.get("spills") is not None for r in b2_build.values()),
              "B2's ptxas report is missing from the build log")
        check(all(r["spills"] == 0 for r in b2_build.values()), "B2 spills registers")
        e1_build = ptxas_entries(logs["exact_epoch"], "exact_epoch")
        for name, r in sorted(e1_build.items()):
            cols = re.search(r"exact_epochILi(\d+)E", name).group(1)
            where = (f"{cols} row values a thread in registers, grad in shared memory"
                     if cols != "0" else "grad in global memory")
            print(f"E1, {where}: {r.get('registers')} registers, {r.get('spills')} bytes "
                  "spilled")
        check(len(e1_build) == 6 and all(r.get("spills") is not None
                                         for r in e1_build.values()),
              "E1's ptxas report is missing from the build log")
        check(all(r["spills"] == 0 for r in e1_build.values()), "E1 spills registers")

    # ------------------------------------------------------ kernel B4 alone
    fp32_p_diff = [0.0]    # bf16: the kernel against the plain version with p in fp32
    slack_ratio = [0.0]    # bf16: the largest excess over one ulp / the rounding slack
    last_slack_ratio = [0.0]   # ... of the last bf16 case compared

    def compare_flash(q, k, v, causal, label):
        got = flash_attention_kernel(q, k, v, causal=causal)
        g = got.float()
        if q.dtype == torch.float32:
            w = flash_attention_plain(q, k, v, causal=causal).float()
            lim, tol = FLASH_TOL + FLASH_TOL * w.abs(), f"{FLASH_TOL} + {FLASH_TOL}|plain|"
            extra = ""
        else:
            # the plain version at the kernel's kv tile rounds p against the
            # same running max as the kernel
            w = flash_attention_plain(q, k, v, causal=causal, kv_tile=kv_tile).float()
            slack = flash_attention_rounding_slack(q, k, v, causal=causal, kv_tile=kv_tile)
            # the slack's yardstick: one bf16 ulp of every term of p . |v| / l
            whole = 2.0 ** -7 * flash_attention_plain(q, k, v.abs(), causal=causal,
                                                      kv_tile=kv_tile).float()
            ulp = BF16_ULP * w.abs() + FLASH_TOL
            lim = ulp + slack
            tol = f"2^-7|plain| + {FLASH_TOL} + rounding slack"
            excess = ((g - w).abs() - ulp).clamp(min=0)
            beyond_ulp = int((excess > 0).sum())
            ratio = (excess / slack.clamp(min=torch.finfo(torch.float32).tiny)).max().item()
            slack_ratio[0] = max(slack_ratio[0], ratio)
            last_slack_ratio[0] = ratio
            slack_share = (slack.sum() / whole.sum()).item()
            # _flash's arithmetic (p kept in fp32) on the same bf16 inputs
            ref = flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
            d32 = (g - ref).abs()
            fp32_beyond = int(((ref - w).abs() > BF16_ULP * w.abs() + FLASH_TOL).sum())
            fp32_p_diff[0] = max(fp32_p_diff[0], d32.max().item())
            extra = (f"; {beyond_ulp} of {w.numel()} beyond one ulp (with p in fp32: "
                     f"{fp32_beyond}); excess / slack {ratio:.3f} (limit 1), slack "
                     f"{slack_share:.2e} of 2^-7 p|v|/l; vs p in fp32 {d32.max().item():.3e} (tol "
                     f"{LIBRARY_TOL} abs and rel)")
            if q.shape[1] == 1000:
                # the same function in another summation order: the plain
                # version on the CPU against itself on the card
                wc = flash_attention_plain(q.cpu(), k.cpu(), v.cpu(), causal=causal,
                                           kv_tile=kv_tile).float().to(dev)
                cpu_excess = ((wc - w).abs() - ulp).clamp(min=0)
                extra += (f"; plain on the CPU: {int((cpu_excess > 0).sum())} beyond one "
                          f"ulp, excess / slack "
                          f"{(cpu_excess / slack.clamp(min=1e-30)).max().item():.3f}")
                del wc, cpu_excess
            del slack, whole, excess
            check(bool((d32 <= LIBRARY_TOL + LIBRARY_TOL * ref.abs()).all()),
                  f"flash {label} strays from _flash's arithmetic (p in fp32)")
            del ref, d32
        err = (g - w).abs()
        print(f"flash {label}: max abs err {err.max().item():.3e} (tol {tol}), "
              f"plain in [{w.min().item():.3e}, {w.max().item():.3e}]{extra}")
        check(got.dtype == q.dtype and bool(torch.isfinite(g).all())
              and bool((err <= lim).all()), f"flash {label} disagrees with its plain version")
        check(q.dtype == torch.float32 or beyond_ulp <= BEYOND_ULP_SHARE * w.numel(),
              f"flash {label}: more than {BEYOND_ULP_SHARE} of the outputs beyond one ulp")
        return err.max().item()

    def qkv(B, S, Hq, Hkv, D, dtype, seed, S_kv=None, Dv=None, strided_v=False):
        """q, k of width D and v of width Dv (D where not given); with
        ``strided_v`` v is the second half of a tensor twice its width, as
        MLA's v is a view of its up-projection's output."""
        g = torch.Generator(device=dev).manual_seed(seed)
        Dv = Dv or D
        q, k = (torch.randn(B, n, h, D, generator=g, device=dev).to(dtype)
                for n, h in ((S, Hq), (S_kv or S, Hkv)))
        v = torch.randn(B, S_kv or S, Hkv, 2 * Dv if strided_v else Dv, generator=g,
                        device=dev).to(dtype)
        return q, k, (v[..., Dv:] if strided_v else v)

    with phase("B4 vs plain"):
        flash_err = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                for D in (64, 96, 128):
                    for Hq, Hkv in ((4, 4), (16, 8), (32, 4), (16, 2)):
                        for S in (1, 63, 64, 127, 128, 129, 255, 257, 1000):
                            q, k, v = qkv(2, S, Hq, Hkv, D, dtype, S + Hq + D)
                            flash_err = max(flash_err, compare_flash(
                                q, k, v, causal, f"{str(dtype)[6:]:8s} causal={causal:d} "
                                f"D={D} Hq/Hkv={Hq}/{Hkv} S={S}"))
            # not causal, k and v of their own length (cross-attention over
            # an encoder's memory): shorter and longer than q, ragged
            for D in (64, 96, 128):
                for Hq, Hkv in ((16, 16), (16, 4)):
                    for S, S_kv in ((37, 16), (64, 1024), (129, 1), (300, 257), (1, 1000),
                                    (128, 129)):
                        q, k, v = qkv(2, S, Hq, Hkv, D, dtype, S + S_kv + D, S_kv)
                        flash_err = max(flash_err, compare_flash(
                            q, k, v, False, f"{str(dtype)[6:]:8s} causal=0 D={D} "
                            f"Hq/Hkv={Hq}/{Hkv} S={S} S_kv={S_kv}"))
            # the (Dqk, Dv) pairs of kimi-k2 (D 112) and MLA (192 / 128, and
            # the reduced 96 / 64), v a strided view at MLA's pairs
            for Dqk, Dv in ((112, 112), (192, 128), (96, 64)):
                for causal in (True, False):
                    for Hq, Hkv in ((4, 4), (16, 8)):
                        for S in (1, 129, 700):
                            q, k, v = qkv(2, S, Hq, Hkv, Dqk, dtype, S + Hq + Dqk, Dv=Dv,
                                          strided_v=Dv != Dqk)
                            flash_err = max(flash_err, compare_flash(
                                q, k, v, causal, f"{str(dtype)[6:]:8s} causal={causal:d} "
                                f"(Dqk, Dv)=({Dqk}, {Dv}) Hq/Hkv={Hq}/{Hkv} S={S}"))
        print(f"bf16: largest difference to the plain version with p in fp32 "
              f"{fp32_p_diff[0]:.3e} (tol {LIBRARY_TOL} abs and rel); largest excess over "
              f"one ulp / rounding slack {slack_ratio[0]:.3f} (limit 1)")

    flash_times = {}
    with phase("B4 timing"):
        # (label, B, S, S_kv, Hq, Hkv, D, Dv, causal): the driver's shape, two
        # text prefills, phi-3-vision's prefixed prefill (576 patch rows and a
        # 64-token prompt, D 96), seamless-m4t's encoder over its 1024 frames
        # and its decoder's cross-attention over them, jamba's attention
        # layer in its B 2 x 512 prefill (32 / 8 heads of 128), deepseek-v2's
        # MLA prefill (2 x 512, 128 heads, q / k 192 wide, v 128: a strided
        # view, whose copy is timed apart), kimi-k2's (2 x 512, 64 / 8 heads
        # of 112), and the driver's deepseek backbone (its reduced MLA, 4
        # heads at (96, 64), a batch of 32 documents of 64 tokens)
        shapes = (("qwen3-0.6b pipeline", 32, 256, 256, 16, 8, 128, 128, True),
                  ("qwen3-0.6b prefill", 1, 4096, 4096, 16, 8, 128, 128, True),
                  ("tinyllama-1.1b prefill", 4, 2048, 2048, 32, 4, 64, 64, True),
                  ("phi-3-vision-4.2b prefill", 4, 640, 640, 32, 32, 96, 96, True),
                  ("seamless-m4t-large-v2 encoder", 4, 1024, 1024, 16, 16, 64, 64, False),
                  ("seamless-m4t-large-v2 cross", 4, 64, 1024, 16, 16, 64, 64, False),
                  ("jamba-v0.1-52b prefill", 2, 512, 512, 32, 8, 128, 128, True),
                  ("deepseek-v2-236b prefill", 2, 512, 512, 128, 128, 192, 128, True),
                  ("kimi-k2-1t-a32b prefill", 2, 512, 512, 64, 8, 112, 112, True),
                  ("deepseek-v2-236b driver backbone", 32, 64, 64, 4, 4, 96, 64, True))
        for label, B, S, S_kv, Hq, Hkv, D, Dv, causal in shapes:
            mla = Dv != D
            q, k, v = qkv(B, S, Hq, Hkv, D, torch.bfloat16, S + S_kv, S_kv, Dv=Dv,
                          strided_v=mla)
            flash_err = max(flash_err, compare_flash(q, k, v, causal,
                                                     f"{label} B={B} S={S} S_kv={S_kv}"))
            excess = last_slack_ratio[0]
            kernel = lambda: flash_attention_kernel(q, k, v, causal=causal)  # noqa: E731
            k_ms, k_b2b = cuda_ms(kernel, 10), cuda_ms_back_to_back(kernel, 50)
            # MLA's v is a strided view: the wrapper's one copy of it, apart
            copy_ms = cuda_ms(lambda: v.contiguous(), 10) if mla else None
            p_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=causal), 3)
            qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))

            def library():    # the yardstick only: the port never calls it
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
            try:
                library()
            except (RuntimeError, ValueError) as exc:   # SDPA refuses the shape
                l_ms = l_b2b = None
                lib_line = f"SDPA none at this shape ({str(exc).splitlines()[0][:80]})"
            else:
                l_ms, l_b2b = cuda_ms(library, 10), cuda_ms_back_to_back(library, 50)
                plain = flash_attention_plain(q, k, v, causal=causal).float()
                lib_diff = (library().transpose(1, 2).float() - plain).abs()
                check(bool((lib_diff <= LIBRARY_TOL + LIBRARY_TOL * plain.abs()).all()),
                      "the SDPA yardstick computes another function")
                lib_line = (f"SDPA {l_ms:.4f} alone, {l_b2b:.4f} back to back [max abs diff "
                            f"to plain {lib_diff.max().item():.3e}]")
                del plain, lib_diff
            b_ms, b_by = flash_bound(B, S, Hq, Hkv, D, torch.bfloat16, causal, S_kv, Dv)
            # ms: one call alone, as every kernel's; back to back beside it
            flash_times[label] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                  "bound_ms": b_ms, "bound_by": b_by,
                                  "ms_back_to_back": k_b2b,
                                  "library_ms_back_to_back": l_b2b,
                                  "excess_of_slack": excess, "v_copy_ms": copy_ms}
            vs_lib = (f"; kernel / SDPA {k_ms / l_ms:.2f} alone, {k_b2b / l_b2b:.2f} back to "
                      "back" if l_ms else "")
            copy = f"; the strided v's copy {copy_ms:.4f} ms of it" if mla else ""
            print(f"flash {label} (B {B}, S {S}, S_kv {S_kv}, Hq/Hkv {Hq}/{Hkv}, (Dqk, Dv) "
                  f"({D}, {Dv}), bf16, causal {causal:d}): "
                  f"{k_ms:.4f} ms alone, {k_b2b:.4f} ms back to back{copy} (plain "
                  f"{p_ms:.3f}; {lib_line}; bound {b_ms:.4f} by {b_by}); kernel / bound "
                  f"{k_ms / b_ms:.2f} alone ({100 * b_ms / k_ms:.1f}% of the bound), "
                  f"{k_b2b / b_ms:.2f} back to back ({100 * b_ms / k_b2b:.1f}%){vs_lib}; bf16 "
                  f"excess over one ulp {excess:.3f} of the rounding slack")
            del q, k, v, qt, kt, vt

    def compare(got, want, label):
        torch.cuda.synchronize()
        err = (got - want).abs()
        lim = GRAM_ATOL + GRAM_RTOL * want.abs()
        print(f"{label}: max abs err {err.max().item():.3e} "
              f"(tol {GRAM_ATOL} + {GRAM_RTOL}|plain|), plain in "
              f"[{want.min().item():.3e}, {want.max().item():.3e}]")
        check(bool(torch.isfinite(got).all()) and bool((err <= lim).all()),
              f"{label} disagrees with its plain version")
        return err.max().item()

    def compare_gram(x, z, kp, label):
        return compare(gram_kernel(x, z, kp), gram_plain(x, z, kp), f"gram {label}")

    def compare_gram_q8(v, sc, z, kp, group, label):
        return compare(gram_q8_kernel(v, sc, z, kp, group),
                       gram_q8_plain(v, sc, z, kp, group), f"gram_q8 {label}")

    gen = torch.Generator(device="cpu").manual_seed(0)
    with phase("B1 vs plain"):
        for kind in ("rbf", "linear", "poly", "tanh"):
            for n, m, p in RAGGED:
                kp = ragged_params(kind, p)
                x = torch.randn(n, p, generator=gen).to(dev)
                z = torch.randn(m, p, generator=gen).to(dev)
                compare_gram(x, z, kp, f"{kind:6s} {n}x{m}x{p}")
        # against fp64: one nonzero element a row, so each dot is one x_k z_k
        # (a dropped piece product errs by up to 2^-16 of it); then sums
        # that cancel (signs mixed, each element from 2^-60 to 2^60)
        rng = np.random.default_rng(0)
        lin = KernelParams("linear")
        for p in (100, 784):
            x = np.zeros((200, p), np.float32)
            x[np.arange(200), rng.integers(0, p, size=200)] = (
                rng.uniform(0.5, 1.5, size=200) * rng.choice([-1.0, 1.0], size=200))
            z = rng.normal(size=(150, p)).astype(np.float32)
            exact = torch.as_tensor(x, dtype=torch.float64) @ torch.as_tensor(z, dtype=torch.float64).T
            got = gram_kernel(torch.as_tensor(x, device=dev), torch.as_tensor(z, device=dev), lin)
            rel = ((got.double().cpu() - exact).abs() / exact.abs()).max().item()
            print(f"gram one nonzero a row, 200x150x{p}, linear: max error / |fp64| {rel:.3e} "
                  f"(tol {SINGLE_TERM_RTOL})")
            check(rel <= SINGLE_TERM_RTOL, f"B1 on one-nonzero rows at p {p} strays from fp64")
        x, z = (np.float32(np.ldexp(rng.choice([-1.0, 1.0], size=(r, 100))
                                    * rng.uniform(1, 2, size=(r, 100)),
                                    rng.integers(-60, 61, size=(r, 100)))) for r in (150, 140))
        x64, z64 = torch.as_tensor(x, dtype=torch.float64), torch.as_tensor(z, dtype=torch.float64)
        got = gram_kernel(torch.as_tensor(x, device=dev), torch.as_tensor(z, device=dev), lin)
        share = ((got.double().cpu() - x64 @ z64.T).abs() / (x64.abs() @ z64.abs().T)).max().item()
        print(f"gram cancelling sums 150x140x100, linear: max error / sum |x||z| {share:.3e} "
              f"(tol {CANCEL_TOL})")
        check(share <= CANCEL_TOL, "B1 on cancelling sums strays from fp64")

    with phase("B3 vs plain"):
        q8_err = 0.0
        for kind in ("rbf", "linear", "poly", "tanh"):
            for n, m, p in RAGGED:
                kp = ragged_params(kind, p)
                # offset rows, so that the affine codec's zero-points are not 0
                x = (torch.randn(n, p, generator=gen) + 0.5).numpy()
                z = torch.randn(m, p, generator=gen).to(dev)
                for codec, sym in (("affine", False), ("symmetric", True)):
                    v, sc = quantize_rows(x, 32, symmetric=sym)
                    q8_err = max(q8_err, compare_gram_q8(
                        torch.as_tensor(v, device=dev),
                        torch.as_tensor(sc, device=dev), z, kp, 32,
                        f"{kind:6s} {codec:9s} {n}x{m}x{p}"))

    with phase("B3 vs fp64"):
        # the per-tile sums (C4) at the streamed chunk's shape, on
        # tools/b3_probe.py's cases, each held at the SIMT B3's error
        rng = np.random.default_rng(0)
        n, m, p = 6281, 2048, 784
        lin = KernelParams("linear")
        cases = []
        x = rng.uniform(0, 1, size=(n, p)).astype(np.float32)
        z = rng.uniform(0, 1, size=(m, p)).astype(np.float32)
        cases.append(("symmetric linear / sum |x||z|", x, z, True, lin))
        cases.append(("symmetric rbf 1/p", x, z, True, KernelParams("rbf", gamma=1.0 / p)))
        xc = (rng.normal(size=(n, p)) + 0.5).astype(np.float32)
        zc = np.float32(np.ldexp(rng.choice([-1.0, 1.0], size=(m, p))
                                 * rng.uniform(1, 2, size=(m, p)),
                                 rng.integers(-60, 61, size=(m, p))))
        cases.append(("cancelling symmetric / sum |x||z|", xc, zc, True, lin))
        cases.append(("cancelling affine / sum |x||z|", xc, zc, False, lin))
        b3_fp64 = {}
        for label, xa, za, sym, kpa in cases:
            v, sc = quantize_rows(xa, 32, symmetric=sym)
            v_d, sc_d = torch.as_tensor(v, device=dev), torch.as_tensor(sc, device=dev)
            z_d = torch.as_tensor(za, device=dev)
            rows = sc_d.double().repeat_interleave(32, dim=0)[:n]
            x64, z64 = v_d.double() * rows[:, :1] + rows[:, 1:], z_d.double()
            dot64 = x64 @ z64.T
            if kpa.kind == "linear":
                want64, size = dot64, x64.abs() @ z64.abs().T
            else:
                d2 = (x64 * x64).sum(1)[:, None] + (z64 * z64).sum(1)[None] - 2 * dot64
                want64, size = torch.exp(-kpa.gamma * d2.clamp(min=0)), 1.0
            got = gram_q8_kernel(v_d, sc_d, z_d, kpa, 32)
            b3_fp64[label] = ((got.double() - want64).abs() / size).max().item()
            print(f"B3 {n}x{m}x{p} {label}: largest error against fp64 "
                  f"{b3_fp64[label]:.4g} (the SIMT B3's {B3_FP64_BARS[label]:.2g})")
            del dot64, want64, size, got, x64, z64
        check(all(b3_fp64[k] <= bar for k, bar in B3_FP64_BARS.items()),
              "B3's error against fp64 is above the SIMT B3's")

    with phase("B1 / B3 tiny elements"):
        # C5, a deliberate difference: an element below 2^-133 of its row's
        # largest leaves no bit in a bf16 piece.  One large element (2^20)
        # and the rest 2^-115 in the split operand, 0 where the other
        # operand meets the large one: fp32 keeps the tiny terms, B1 and B3
        # return 0
        rng = np.random.default_rng(1)
        n, m, p = 70, 50, 100
        tiny = np.full((n, p), 2.0 ** -115, np.float32)
        tiny[:, 0] = 2.0 ** 20
        other = rng.uniform(0.5, 1.5, size=(m, p)).astype(np.float32)
        other[:, 0] = 0.0
        fp32 = tiny @ other.T
        got1 = gram_kernel(torch.as_tensor(tiny, device=dev),
                           torch.as_tensor(other, device=dev), KernelParams("linear"))
        v, sc = quantize_rows(other, 32, symmetric=True)
        got3 = gram_q8_kernel(torch.as_tensor(v, device=dev), torch.as_tensor(sc, device=dev),
                              torch.as_tensor(tiny, device=dev), KernelParams("linear"), 32)
        print(f"rows of one 2^20 and 2^-115 elsewhere: an fp32 product keeps the tiny "
              f"terms ({fp32.min():.4g} .. {fp32.max():.4g}); B1 returns "
              f"{got1.abs().max().item()} at most, B3 {got3.abs().max().item()}")
        check(bool(np.all(fp32 > 0)), "fp32 lost the tiny terms")
        check(not bool(got1.any()) and not bool(got3.any()),
              "B1 or B3 no longer returns 0 for elements below bf16's range")

    with phase("data"):
        x, y = make_multiclass(70000, p=784, n_classes=10, sep=0.07, within=0.06,
                               seed=0)
        xtr, ytr, xte, yte = x[:60000], y[:60000], x[60000:], y[60000:]
        gamma = median_gamma(xtr)
        kp = KernelParams("rbf", gamma=gamma)
        print(f"train {xtr.shape} test {xte.shape} classes 10 gamma {gamma:.6e}")

    budget = 2048
    with phase("B1 vs plain, main-path shapes"):
        xtr_d = torch.as_tensor(xtr, device=dev)
        xte_d = torch.as_tensor(xte, device=dev)
        lm = select_landmarks(xtr_d, budget, seed=0)
        shape = "{}x{}x{}".format
        gram_err = max(
            compare_gram(lm, lm, kp, f"K_mm {shape(budget, budget, lm.shape[1])}"),
            compare_gram(xtr_d, lm, kp, f"K_nm {shape(len(xtr_d), budget, lm.shape[1])}"),
            compare_gram(xte_d, lm, kp, f"predict {shape(len(xte_d), budget, lm.shape[1])}"))
        # K_mm against fp64 within the fp32 form's worst-case rounding,
        # gamma 4 p eps (||x_i||^2 + ||x_j||^2): the form cancels on and
        # near the diagonal, which feeds eigh and its eigenvalue drop
        lm64 = lm.double()
        sq64 = (lm64 * lm64).sum(-1)
        d2_64 = (sq64[:, None] + sq64[None] - 2 * lm64 @ lm64.T).clamp(min=0)
        eps32 = torch.finfo(torch.float32).eps
        for mult in (1, 4):
            g = mult * kp.gamma
            kmm = gram_kernel(lm, lm, KernelParams("rbf", gamma=g)).double()
            tol = g * 4 * lm.shape[1] * eps32 * (sq64[:, None] + sq64[None])
            share = ((kmm - torch.exp(-g * d2_64)).abs() / tol).max().item()
            diag = kmm.diagonal()
            print(f"gram K_mm at {mult}x the median gamma vs fp64: largest share of the "
                  f"rounding bound {share:.3e} (max 1), diagonal in [{diag.min().item():.9f}, "
                  f"{diag.max().item():.9f}]")
            check(share <= 1 and bool((diag <= 1).all()), f"B1's K_mm at {mult}x gamma strays "
                  "from fp64")
        del lm64, d2_64, kmm, tol

    def smo_state(G, tasks, alpha, unchanged, w, live):
        return dict(G=G, q=(G * G).sum(-1), idx=tasks.idx, y=tasks.y, c=tasks.c,
                    alpha=alpha, unchanged=unchanged, w=w, live=live)

    def compare_smo(state, full_pass, label, shrink_k=5, **window):
        """Run kernel and plain version on copies of ``state`` (``window``:
        B2's window form); returns the largest abs error of alpha and w."""
        runs = []
        for fn in (smo_epoch_kernel, smo_epoch_plain):
            s = {k: v.clone() for k, v in state.items()}
            viol = fn(**s, full_pass=full_pass, shrink_k=shrink_k, **window)
            runs.append((s, viol))
        torch.cuda.synchronize()
        (k, vk), (p, vp) = runs
        a_err = (k["alpha"] - p["alpha"]).abs().max().item()
        w_err = (k["w"] - p["w"]).abs().max().item()
        w_tol = W_RTOL * max(p["w"].abs().max().item(), 1.0)
        v_err = ((vk - vp).abs() / vp.abs().clamp(min=1e-6)).max().item()
        agree = (k["unchanged"] == p["unchanged"]).float().mean().item()
        print(f"smo {label}: alpha err {a_err:.3e} (tol {ALPHA_ATOL}), w err "
              f"{w_err:.3e} (tol {w_tol:.3e}), viol max rel err {v_err:.3e} "
              f"(tol {VIOL_RTOL}), unchanged agree {agree:.5f} "
              f"(min {UNCHANGED_MIN_AGREE})")
        check(a_err <= ALPHA_ATOL and w_err <= w_tol and v_err <= VIOL_RTOL
              and agree >= UNCHANGED_MIN_AGREE,
              f"smo {label} disagrees with its plain version")
        check(bool(torch.isfinite(k["w"]).all()), f"smo {label}: w not finite")
        return max(a_err, w_err)

    with phase("B2 vs plain"):
        rng = np.random.default_rng(0)
        for B, full_pass in ((300, True), (300, False), (2048, True), (2048, False)):
            T, n_pad, n_rows = 4, 1000, 3000
            G = torch.as_tensor(rng.normal(size=(n_rows, B)) / np.sqrt(B),
                                dtype=torch.float32, device=dev)
            idx = np.stack([rng.choice(n_rows, n_pad, replace=False) for _ in range(T)])
            c = np.full((T, n_pad), 1.0, np.float32)
            c[:, -37:] = 0.0                                  # padding rows
            yv = rng.choice([-1.0, 1.0], size=(T, n_pad)).astype(np.float32)
            a0 = (rng.uniform(0, 1, size=(T, n_pad)) * (c > 0)).astype(np.float32)
            tasks = tasks_from_reference(idx, yv, c, a0, device=dev)
            w0 = torch.stack([(tasks.alpha0[t] * tasks.y[t]) @ G[tasks.idx[t].long()]
                              for t in range(T)])
            unch = torch.as_tensor(rng.integers(0, 8, size=(T, n_pad)),
                                   dtype=torch.int32, device=dev)
            live = torch.tensor([True, True, False, True], device=dev)
            compare_smo(smo_state(G, tasks, tasks.alpha0.clone(), unch, w0, live),
                        full_pass, f"full_pass={full_pass} T={T}x{n_pad} B={B}")

    with phase("main path"):
        svm = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2)
        gram_kernel.launches = 0
        smo_epoch_kernel.launches = 0
        t0 = time.perf_counter()
        svm.fit(xtr, ytr)
        t_pred = time.perf_counter()
        pred = svm.predict(xte)
        t_pred = time.perf_counter() - t_pred
        launches = {"gram": gram_kernel.launches, "smo_epoch": smo_epoch_kernel.launches}
        wall = time.perf_counter() - t0
        err = float(np.mean(pred != yte))
        dec = svm.decision_function(xte)
        st = svm.stats
        tasks = svm.tasks_
        real = tasks.c > 0
        alpha = svm.alpha_
        n_zero = int(((alpha <= 0) & real).sum())
        n_at_c = int(((alpha >= tasks.c) & real).sum())
        n_free = int(real.sum()) - n_zero - n_at_c
        print(f"stage1 {st.stage1_seconds:.3f} s, stage2 {st.stage2_seconds:.3f} s, "
              f"predict {t_pred:.3f} s, fit->predict wall {wall:.3f} s")
        print(f"effective rank {st.effective_rank}, tasks {st.n_tasks}, epochs max "
              f"{st.epochs.max()} mean {st.epochs.mean():.2f}, tasks converged "
              f"{int((st.violations < 1e-2).sum())}")
        print(f"launches {launches}")
        print(f"alphas: {n_zero} at 0, {n_free} free, {n_at_c} at C; "
              f"test error {err:.4f}")
        check(launches["gram"] >= 3, "gram launched fewer than 3 times on the main path")
        check(launches["smo_epoch"] >= int(st.epochs.max()),
              "smo_epoch launched fewer times than the fit had epochs")
        check(dec.shape == (len(xte), 45) and bool(np.isfinite(dec).all()),
              "decision values of the wrong shape or not finite")
        check(0.005 <= err <= 0.25, f"test error {err} outside [0.005, 0.25]")
        check(n_at_c > 0, "no alpha at C: the box clip never acted")
        fac = svm.factor
        plain = (gram_plain(xte_d, fac.landmarks, kp) @ fac.projector) @ svm.W_.T
        d_err = float(np.abs(dec - plain.cpu().numpy()).max())
        d_tol = DECISION_RTOL * float(np.abs(dec).max())
        print(f"decision values {dec.shape} vs plain path from the same factor: "
              f"max abs err {d_err:.3e} (tol {d_tol:.3e})")
        check(d_err <= d_tol, "decision values disagree with the plain path")
        w_re = torch.stack([(alpha[t] * tasks.y[t]) @ fac.G[tasks.idx[t].long()]
                            for t in range(tasks.n_tasks)])
        w_err = (w_re - svm.W_).abs().max().item()
        w_tol = W_RTOL * svm.W_.abs().max().item()
        print(f"fitted w vs sum alpha_i y_i g_i: max abs err {w_err:.3e} (tol {w_tol:.3e})")
        check(w_err <= w_tol, "the w the kernel carried drifted from its alphas")

    with phase("B2 vs plain, main-path shape"):
        G = fac.G
        T, n_pad = tasks.idx.shape
        live = torch.ones(T, dtype=torch.bool, device=dev)
        zeros = torch.zeros((T, n_pad), dtype=torch.float32, device=dev)
        state0 = smo_state(G, tasks, zeros.clone(),
                           torch.zeros((T, n_pad), dtype=torch.int32, device=dev),
                           torch.zeros((T, G.shape[1]), device=dev), live)
        smo_err = compare_smo(state0, True, f"full epoch from 0, {T} tasks x {n_pad} "
                              f"rows, B'={G.shape[1]}")
        # cheap epoch from the fit: rows at a bound count as shrunk, free rows run
        at_bound = (alpha <= 0) | (alpha >= tasks.c)
        unch = torch.where(at_bound, 5, 0).to(torch.int32)
        state1 = smo_state(G, tasks, alpha.clone(), unch, svm.W_.clone(), live)
        smo_err = max(smo_err, compare_smo(
            state1, False, f"cheap epoch from the fit, {int((~at_bound).sum())} free rows"))

    with phase("card vs cpu"):
        xs, ys = make_multiclass(2000, p=20, n_classes=5, seed=3)
        kps = KernelParams("rbf", gamma=median_gamma(xs))
        fac_s = compute_factor(xs, kps, 256, seed=0, device=dev)
        res = {}
        for d in ("cuda", "cpu"):      # one factor: this holds stage 2 and predict
            f = dataclasses.replace(fac_s, **{k: getattr(fac_s, k).to(d) for k in
                                              ("G", "landmarks", "projector", "eigvals")})
            s = LPDSVM(kernel=kps, C=1.0, budget=256, tol=1e-2, device=d)
            s.fit(xs, ys, factor=f)
            res[d] = (s.predict(xs), s.alpha_.cpu(), s.W_.cpu(), s.stats.epochs)
        agree = float(np.mean(res["cuda"][0] == res["cpu"][0]))
        dual = {d: (r[1].sum(-1) - 0.5 * (r[2] * r[2]).sum(-1)).numpy()
                for d, r in res.items()}
        rel = float(np.max(np.abs(dual["cuda"] - dual["cpu"]) / np.abs(dual["cpu"])))
        print(f"small fit (2000 x 20, 5 classes, B 256): prediction agreement "
              f"{agree:.4f} (min 0.99), dual objective max rel diff {rel:.3e} "
              f"(max 5e-3), epochs card {res['cuda'][3].tolist()} cpu "
              f"{res['cpu'][3].tolist()}")
        check(agree >= 0.99 and rel <= 5e-3, "the card's fit disagrees with the CPU's")

    def polish_levels(ptrace) -> int:
        """One line a level; returns the B2 launches the levels account for
        (a monolithic level launches B2 once an epoch while a task is live,
        a streamed one once a block)."""
        total = 0
        for lv in ptrace.levels:
            calls = (lv.stream_stats.kernel_calls if lv.streamed
                     else int(lv.epochs.max()))
            total += calls
            print(f"polish level {lv.fraction:.4g}: {lv.n_rows} rows, n_pad {lv.n_pad}, "
                  f"{'streamed' if lv.streamed else 'monolithic'}, tol {lv.tol:.3g}, "
                  f"epochs max {int(lv.epochs.max())} mean {lv.epochs.mean():.2f}, "
                  f"B2 launches {calls}, largest gap {np.nanmax(lv.duality_gap):.4g}, "
                  f"{lv.seconds:.3f} s")
        return total

    def task_gaps(G_d, tasks_c, alpha) -> np.ndarray:
        return np.array([float(dual_solver.duality_gap(
            G_d, tasks_c.idx[t], tasks_c.y[t], tasks_c.c[t], alpha[t]))
            for t in range(tasks_c.n_tasks)])

    def against_cold(pol, cold, G_d, pred_p, pred_c, label, same_cadence):
        """tests/test_polish.py::_assert_matches_cold's checks on the card
        (violations under tol, alphas in their box, w within 0.05 of its
        scale), and the test errors and predictions of the two fits.

        The duality gap is measured, per task against the cold fit with the
        test's slack tol (1 + |dual_t|) and in benchmarks/polish.py's form
        (the largest gap against the cold's largest plus tol (1 + max
        |dual_t|)), each also against ``same_cadence``, a cold solve at the
        final level's cadence (that benchmark's cold_p1 baseline).  At this
        width neither form holds on both routes (PERF.md, section 6): both fits
        stop at the same KKT tolerance, but the ladder's final level checks
        it every epoch (period 1; 5 streamed) and stops at the first pass
        under it, where the cold fit's cheap epochs between full passes
        (period 20) end deeper inside it; the cold solve at the ladder's
        cadence has gaps of the same size.  Held instead: every gap, of both
        fits, within what the stop implies, C tol m_t: the gap is the sum
        over a task's m_t rows of alpha_i G_i + C max(0, -G_i) (G_i the
        dual gradient, y_i w.g_i - 1), and a projected gradient of at most
        tol bounds each term by C tol."""
        tasks_c = cold.tasks_
        tol = cold.config.tol
        viol = pol.stats.violations
        a, c = pol.alpha_, tasks_c.c
        dual_c = (cold.alpha_.sum(-1) - 0.5 * (cold.W_ * cold.W_).sum(-1)).cpu().numpy()
        slack = tol * (1.0 + np.abs(dual_c))
        gp = task_gaps(G_d, tasks_c, pol.alpha_)
        base = {"cold": task_gaps(G_d, tasks_c, cold.alpha_),
                "cold at the final level's cadence": task_gaps(G_d, tasks_c,
                                                               same_cadence.alpha)}
        for name, gc in base.items():
            ex = gp - gc - slack
            t = int(ex.argmax())
            target = gc.max() + tol * (1.0 + np.abs(dual_c).max())
            print(f"{label}: largest gap {gp.max():.4g}, {name} {gc.max():.4g} (measured, "
                  f"not held): per task {int((ex > 0).sum())} of {len(ex)} above the "
                  f"{name}'s gap + tol (1 + |dual_t|), worst task {t} {gp[t]:.4g} against "
                  f"{gc[t]:.4g} + {slack[t]:.4g}; largest against the {name}'s largest "
                  f"+ tol (1 + max |dual_t|) = {target:.4g}: "
                  f"{'within' if gp.max() <= target else 'above'}")
        print(f"{label}: epochs max {int(cold.stats.epochs.max())} cold, "
              f"{int(same_cadence.epochs.max())} cold at the final level's cadence, "
              f"dual up to {np.abs(dual_c).max():.4g}")
        rows = (tasks_c.c > 0).sum(-1).cpu().numpy()
        kkt_bound = float(tasks_c.c.max()) * tol * rows
        within = bool(np.all(gp <= kkt_bound) and np.all(base["cold"] <= kkt_bound))
        wscale = max(1.0, cold.W_.abs().max().item())
        w_diff = (pol.W_ - cold.W_).abs().max().item()
        err_p, err_c = float(np.mean(pred_p != yte)), float(np.mean(pred_c != yte))
        agree = float(np.mean(pred_p == pred_c))
        print(f"{label} against the cold fit: largest violation {viol.max():.4g} (tol "
              f"{tol}); alphas in [{a.min().item():.4g}, box]: "
              f"{bool((a >= 0).all() and (a <= c + 1e-5).all())}; every gap within C "
              f"tol m_t ({kkt_bound.min():.4g} .. {kkt_bound.max():.4g}): {within}; max "
              f"|w - w_cold| {w_diff:.4g} (limit {POLISH_W_SHARE * wscale:.4g}); test "
              f"error {err_p:.4f} (cold {err_c:.4f}), prediction agreement {agree:.4f}; "
              f"stage 2 {pol.stats.stage2_seconds:.3f} s (cold "
              f"{cold.stats.stage2_seconds:.3f} s)")
        check(bool(np.all(viol < tol)), f"{label}: a final violation is not under tol")
        check(bool((a >= 0).all() and (a <= c + 1e-5).all()),
              f"{label}: an alpha left its box")
        check(within, f"{label}: a duality gap above what the KKT stop implies")
        check(w_diff <= POLISH_W_SHARE * wscale, f"{label}: w strays from the cold fit's")
        check(abs(err_p - err_c) <= POLISH_ERR_DIFF, f"{label}: test error off the cold fit's")
        check(agree >= POLISH_MIN_AGREE, f"{label}: predictions agree {agree} < "
              f"{POLISH_MIN_AGREE}")

    with phase("polished main path"):
        # the main path's data, solver and budget with polish=True on the
        # main path's factor; counts reset just before and read just after
        svm_p = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2, polish=True)
        for fn in (gram_kernel, gram_q8_kernel, smo_epoch_kernel):
            fn.launches = 0
        t0 = time.perf_counter()
        svm_p.fit(xtr, ytr, factor=svm.factor)
        pred_p = svm_p.predict(xte)
        wall_p = time.perf_counter() - t0
        p_launches = {"gram": gram_kernel.launches, "gram_q8": gram_q8_kernel.launches,
                      "smo_epoch": smo_epoch_kernel.launches}
        ptr = svm_p.stats.polish_trace
        accounted = polish_levels(ptr)
        print(f"launches {p_launches}; the levels account for {accounted} B2 launches; "
              f"fit (stage 2) -> predict wall {wall_p:.3f} s")
        check(svm_p.stats.polished and len(ptr.levels) >= 2, "the ladder did not run")
        check(not any(lv.streamed for lv in ptr.levels), "a monolithic level streamed")
        check(all(int(lv.epochs.max()) > 0 for lv in ptr.levels),
              "a level ran no epoch of B2")
        check(p_launches["smo_epoch"] == accounted > 0,
              "B2 launches differ from the levels' epochs")
        check(p_launches["gram"] == 1 and p_launches["gram_q8"] == 0,
              "B1 not launched once for the predict features")
        cold_p1 = dual_solver.solve_batch(svm.factor.G, svm.tasks_, dataclasses.replace(
            svm.config, full_pass_period=svm_p.polish_schedule.full_pass_period))
        against_cold(svm_p, svm, svm.factor.G, pred_p, pred, "polished main path", cold_p1)
        del cold_p1
        # the warm start every level after the first takes: w0 = sum alpha y g
        # a task, in fp64 (dual_solver._init_w), at the final level's width
        tasks = svm.tasks_
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dual_solver._init_w(svm.factor.G, tasks.idx.to(torch.int32), tasks.y,
                            svm_p.alpha_)
        torch.cuda.synchronize()
        print(f"warm-start w0 of the final level ({tasks.n_tasks} tasks x "
              f"{tasks.idx.shape[1]} rows x {svm.factor.G.shape[1]}, fp64): "
              f"{time.perf_counter() - t0:.4f} s")

    with phase("timing"):
        n, m, p = xtr_d.shape[0], lm.shape[0], xtr_d.shape[1]
        g_ms = cuda_ms(lambda: gram_kernel(xtr_d, lm, kp), 10)
        g_b2b = cuda_ms_back_to_back(lambda: gram_kernel(xtr_d, lm, kp), 50)
        g_plain = cuda_ms(lambda: gram_plain(xtr_d, lm, kp), 10)

        def library():   # cuBLAS fp32 product with the RBF epilogue in place
            xsq = (xtr_d * xtr_d).sum(-1)
            zsq = (lm * lm).sum(-1)
            k = torch.addmm(xsq[:, None], xtr_d, lm.T, alpha=-2.0)
            return k.add_(zsq[None, :]).clamp_min_(0.0).mul_(-kp.gamma).exp_()
        g_lib = cuda_ms(library, 10)
        g_bound, g_by = gram_bound(n, m, p)
        g_bound_cc, _ = gram_bound_cuda_cores(n, m, p)
        pr_ms = cuda_ms(lambda: gram_kernel(xte_d, lm, kp), 10)
        pr_b2b = cuda_ms_back_to_back(lambda: gram_kernel(xte_d, lm, kp), 50)
        pr_bound, _ = gram_bound(xte_d.shape[0], m, p)
        mm_b1 = cuda_ms(lambda: gram_kernel(lm, lm, kp), 10)
        mm_bound, _ = gram_bound(m, m, p)
        print(f"gram {n}x{m}x{p}: {g_ms:.4f} ms alone, {g_b2b:.4f} back to back (plain "
              f"{g_plain:.3f}, library {g_lib:.3f}, bound {g_bound:.4f} by {g_by} for 6 bf16 "
              f"passes on the tensor cores, {g_bound_cc:.3f} as one fp32 pass on the CUDA "
              f"cores; {100 * g_bound / g_b2b:.1f}% of the bound back to back); predict shape "
              f"{xte_d.shape[0]}x{m}x{p}: {pr_ms:.4f} ms alone, {pr_b2b:.4f} back to back "
              f"(bound {pr_bound:.4f}); K_mm {m}x{m}x{p}: {mm_b1:.4f} ms alone (bound "
              f"{mm_bound:.4f})")

        work = {}

        def reset(state):
            def go():
                work.clear()
                work.update({k: v.clone() for k, v in state.items()})
            return go

        def run(fn, full_pass, **window):
            return lambda: fn(**work, full_pass=full_pass, shrink_k=5, **window)

        s_ms = cuda_ms(run(smo_epoch_kernel, True), 5, reset(state0))
        changed = int((work["alpha"] != state0["alpha"]).sum())   # rows whose w update ran
        s_plain = cuda_ms(run(smo_epoch_plain, True), 1, reset(state0))
        cheap_ms = cuda_ms(run(smo_epoch_kernel, False), 5, reset(state1))
        # the full epoch from zero reads every real row once per task; the
        # bound counts each input once: the G rows any task reads, the task
        # vectors, w in and out
        real_rows = int(real.sum())
        g_rows = int(torch.unique(tasks.idx[real]).numel())
        Bp = G.shape[1]
        nbytes = 4.0 * (g_rows * Bp + g_rows + 7 * T * n_pad + 2 * T * Bp + T)
        s_bound, s_by = bound_ms(2.0 * Bp * real_rows + 2.0 * Bp * changed, nbytes)
        print(f"smo full epoch {T} tasks x {n_pad} rows, B'={Bp}: {s_ms:.3f} ms "
              f"(plain {s_plain:.1f}, bound {s_bound:.4f} by {s_by}); cheap epoch "
              f"from the fit: {cheap_ms:.3f} ms; ring of {ring_stages(Bp)} stages")
        # the cheap epoch's active rows: free rows (unchanged 0) of each task;
        # the blocks run side by side, so the largest task sets the time
        cheap_rows = (~at_bound & real).sum(1)
        n_cheap, n_cheap_max = int(cheap_rows.sum()), int(cheap_rows.max())
        print(f"cheap epoch: {n_cheap} active rows in {T} tasks, {n_cheap_max} in the "
              f"largest: {cheap_ms * 1e6 / max(n_cheap_max, 1):.1f} ns per active row "
              f"of the largest task, {cheap_ms * 1e6 / max(n_cheap, 1):.2f} ns per "
              f"active row of all; full epoch {s_ms * 1e6 / n_pad:.1f} ns per position")

        # stage 2 again on the main path's factor with a CUDA event pair
        # around every B2 launch: the events' sum against the wall time
        events = []
        solve_epoch = dual_solver.smo_epoch

        def timed_epoch(*args, full_pass, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            viol = solve_epoch(*args, full_pass=full_pass, **kw)
            end.record()
            events.append((full_pass, start, end))
            return viol

        dual_solver.smo_epoch = timed_epoch
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res2 = dual_solver.solve_batch(G, tasks, svm.config)
            torch.cuda.synchronize()
            wall2 = time.perf_counter() - t0
        finally:
            dual_solver.smo_epoch = solve_epoch
        ev = [(f, s.elapsed_time(e)) for f, s, e in events]
        ev_full = [t for f, t in ev if f]
        ev_cheap = [t for f, t in ev if not f]
        ev_s = (sum(ev_full) + sum(ev_cheap)) / 1e3
        print(f"stage 2 again on the main path's factor: wall {wall2:.4f} s, B2 events "
              f"{ev_s:.4f} s ({ev_s / wall2:.3f} of the wall) over {len(ev)} launches: "
              f"{len(ev_full)} full epochs {sum(ev_full):.3f} ms, {len(ev_cheap)} cheap "
              f"{sum(ev_cheap):.3f} ms; the fit's stage 2 {st.stage2_seconds:.4f} s")
        check(torch.equal(res2.alpha, svm.alpha_) and len(ev) == launches["smo_epoch"],
              "stage 2 again did not repeat the fit's solve")
        eig_ms = cuda_ms(lambda: torch.linalg.eigh(gram_kernel(lm, lm, kp)), 3)
        k_nm = gram_kernel(xtr_d, lm, kp)
        mm_ms = cuda_ms(lambda: k_nm @ fac.projector, 5)
        t0 = time.perf_counter()
        compute_factor(xtr, kp, budget, seed=0, device=dev)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        print(f"stage-1 parts: K_mm + eigh {budget}x{budget} {eig_ms:.3f} ms, "
              f"K_nm @ projector {mm_ms:.3f} ms; stage 1 again in this process "
              f"{warm_s:.3f} s")

    # ------------------------------------------------------ the streamed route
    cfg = StreamConfig(device_budget_bytes=256 << 20, stage1_dtype="int8",
                       prefetch=2, autotune_prefetch=False)
    group = cfg.quant_group_rows
    n_tr, p_tr = xtr.shape
    chunk = auto_chunk_rows(n_tr, p_tr, budget, cfg)
    with phase("B3 vs plain, chunk shape"):
        # the first stage-1 chunk of the streamed path, as its wire carries it
        v, sc = quantize_rows(xtr[:chunk], group, symmetric=True)
        v_d, sc_d = torch.as_tensor(v, device=dev), torch.as_tensor(sc, device=dev)
        q8_err = max(q8_err, compare_gram_q8(
            v_d, sc_d, lm, kp, group, f"stage-1 chunk {chunk}x{budget}x{p_tr}"))
        # the pre-pass's exact split of the landmarks, against the CPU's
        pieces, pow2 = split_bf16x3_kernel(lm)
        want, want_pow2 = split_bf16x3(lm.cpu())
        same = (torch.equal(pieces[:, :, :p_tr].cpu().view(torch.int16),
                            want.view(torch.int16))
                and not bool(pieces[:, :, p_tr:].float().any())
                and torch.equal(pow2.cpu(), want_pow2))
        exact = torch.equal(want.double().sum(0) * want_pow2.double()[:, None],
                            lm.cpu().double())
        print(f"B3 pre-pass pieces of the {budget} landmarks bit-equal to "
              f"split_bf16x3 {same}; their sum times 2^e equal to the landmarks {exact}")
        check(same and exact, "B3's pre-pass does not split z exactly as split_bf16x3")
        del pieces, pow2, want, want_pow2

    with phase("streamed path"):
        # stage 1 alone, for its peak device memory: the byte model counts
        # the landmarks, the projector and the chunks in flight; it leaves
        # out the eigh phase before the first chunk (K_mm, its symmetrised
        # copy, the eigenvectors, two reordered and scaled copies, and about
        # 2 B^2 of eigensolver workspace)
        base = peak_start()
        fac1 = compute_factor(xtr, kp, budget, seed=0, device=dev, stream_config=cfg)
        peak1 = peak_since(base)
        allow1 = 4 * 7 * budget * budget
        print(f"stage 1 alone: streamed {fac1.streamed}, peak device memory "
              f"{peak1} B: budget {cfg.device_budget_bytes} + eigh allowance "
              f"{allow1} = {cfg.device_budget_bytes + allow1}")
        check(fac1.streamed, "stage 1 did not stream")
        check(peak1 <= cfg.device_budget_bytes + allow1,
              "stage 1 peak device memory above the budget plus the allowance")

        svm_s = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2, stream_config=cfg)
        gram_kernel.launches = 0
        gram_q8_kernel.launches = 0
        smo_epoch_kernel.launches = 0
        t0 = time.perf_counter()
        svm_s.fit(xtr, ytr)
        pred_s = svm_s.predict(xte)
        wall_s = time.perf_counter() - t0
        s_launches = {"gram": gram_kernel.launches, "gram_q8": gram_q8_kernel.launches,
                      "smo_epoch": smo_epoch_kernel.launches}
        st = svm_s.stats
        s1, s2 = st.stage1_stats, st.stage2_stats
        fac_s = svm_s.factor
        rank = fac_s.effective_rank
        T, n_pad = svm_s.tasks_.idx.shape
        err_s = float(np.mean(pred_s != yte))
        agree = float(np.mean(pred_s == pred))
        g_bytes = n_tr * rank * 4
        g_same = torch.equal(fac1.G, fac_s.G)
        print(f"stage 1 twice on the same data (alone, then in the fit): G "
              f"bit-equal {g_same}, max abs diff "
              f"{(fac1.G - fac_s.G).abs().max().item():.3e}")
        del fac1
        print(f"route: stage 1 streamed {st.stage1_streamed}, stage 2 streamed "
              f"{st.stage2_streamed}; chunks {s1.chunks} of {chunk} rows, tile "
              f"{s2.tile_rows} rows, launches {s_launches}")
        print(f"stage1 {st.stage1_seconds:.3f} s, stage2 {st.stage2_seconds:.3f} s, "
              f"fit->predict wall {wall_s:.3f} s; epochs max {st.epochs.max()}, "
              f"full passes {s2.full_passes}, blocks {s2.blocks_streamed}")
        print(f"stage 1 wire {s1.wire_dtype}: bytes_h2d {s1.bytes_h2d} (scales "
              f"{s1.bytes_scales}) against {n_tr * p_tr * 4} on the f32 wire; "
              f"h2d {s1.h2d_gbps:.2f} GB/s, overlap {s1.overlap_efficiency:.3f}, "
              f"encode {s1.encode_seconds:.3f} s, put {s1.put_seconds:.3f} s, "
              f"drain {s1.drain_seconds:.3f} s, pinned G {s1.alloc_seconds:.3f} s, "
              f"prefetch_final {s1.prefetch_final}")
        print(f"stage 2 wire {s2.block_dtype}: bytes_h2d {s2.bytes_h2d}, bytes_g "
              f"{s2.bytes_g}, bytes_d2h {s2.bytes_d2h}; h2d {s2.h2d_gbps:.2f} GB/s, "
              f"overlap {s2.overlap_efficiency:.3f}, put {s2.put_seconds:.3f} s, "
              f"drain {s2.drain_seconds:.3f} s, compaction {s2.compact_seconds:.3f} s, "
              f"prefetch_final {s2.prefetch_final}, coord_visits {s2.coord_visits}")
        print(f"epoch_bytes first 3 {s2.epoch_bytes[:3]}, last 3 "
              f"{s2.epoch_bytes[-3:]}, total {sum(s2.epoch_bytes)}; active_history "
              f"{s2.active_history}")
        print(f"test error {err_s:.4f} (monolithic {err:.4f}), prediction "
              f"agreement with the monolithic fit {agree:.4f}")
        check(st.stage1_streamed and st.stage2_streamed, "a stage did not stream")
        check(s_launches["gram_q8"] == s1.chunks > 1,
              "B3 was not launched once per stage-1 chunk")
        check(s_launches["gram"] == 2, "B1 not launched once for K_mm and once "
              "for the prediction features")
        check(s_launches["smo_epoch"] == s2.kernel_calls > 0,
              "B2 launches differ from the streamed blocks")
        check(fac_s.G.device.type == "cpu" and fac_s.G.is_pinned(),
              "the streamed G is not a pinned host tensor")
        check(agree >= 0.99, f"streamed predictions agree {agree} < 0.99")
        check(abs(err_s - err) <= 0.005, "streamed test error off by > 0.5 points")
        check(bool(np.all(st.violations < 1e-2)), "a streamed task did not converge")
        check(s2.epoch_bytes[0] == g_bytes,
              f"first full pass streamed {s2.epoch_bytes[0]} G bytes, not n B' 4")

        # stage 2 alone, for its peak: the byte model counts w and the G
        # blocks in flight; it leaves out the task state on the card
        # (TaskBatch idx/y/c/alpha0, the sorted copies sidx/y/c/alpha/
        # unchanged, the int64 permutation, the compacted index table old and
        # new while it is replaced: 13 words per task position), q (one
        # word per row of G) and B2's active-list scratch (8 words per
        # position of the widest window, one per solve: s2.scratch_bytes).
        # The factor's landmarks and projector are there before the start.
        allow2 = 4 * (13 * T * n_pad + n_tr) + s2.scratch_bytes
        limit2 = cfg.device_budget_bytes + allow2
        base = peak_start()
        svm2 = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2, stream_config=cfg)
        svm2.fit(xtr, ytr, factor=fac_s)
        peak2 = peak_since(base)
        same = (np.array_equal(svm2.stats.epochs, st.epochs)
                and torch.equal(svm2.alpha_, svm_s.alpha_)
                and torch.equal(svm2.W_, svm_s.W_))
        print(f"stage 2 alone, f32 blocks: {svm2.stats.stage2_seconds:.3f} s, "
              f"peak device memory {peak2} B: budget {cfg.device_budget_bytes} "
              f"+ task-state allowance {allow2} (B2 scratch {s2.scratch_bytes}) = "
              f"{limit2}; G is {g_bytes} B "
              f"(peak / G {peak2 / g_bytes:.3f}); epochs, alphas and w equal "
              f"to the fit's {same}")
        check(svm2.stats.stage2_streamed and same,
              "stage 2 on the same factor did not repeat the fit's solve")
        check(peak2 <= limit2,
              "stage 2 peak device memory above the budget plus the allowance")

        cfg16 = dataclasses.replace(cfg, block_dtype="bf16")
        svm16 = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2, stream_config=cfg16)
        base = peak_start()
        svm16.fit(xtr, ytr, factor=fac_s)
        peak16 = peak_since(base)
        pred16 = svm16.predict(xte)
        b16 = svm16.stats.stage2_stats
        agree16 = float(np.mean(pred16 == pred))
        print(f"stage 2 again, bf16 blocks: {svm16.stats.stage2_seconds:.3f} s, "
              f"epochs max {svm16.stats.epochs.max()}, first full pass "
              f"{b16.epoch_bytes[0]} B (f32 {s2.epoch_bytes[0]}), h2d "
              f"{b16.h2d_gbps:.2f} GB/s, test error "
              f"{float(np.mean(pred16 != yte)):.4f}, agreement {agree16:.4f}, "
              f"peak device memory {peak16} B (limit {limit2})")
        check(svm16.stats.stage2_streamed and b16.epoch_bytes[0] * 2 == g_bytes,
              "bf16 blocks did not halve the first full pass")
        check(agree16 >= 0.99, f"bf16 predictions agree {agree16} < 0.99")
        check(peak16 <= limit2,
              "bf16 stage 2 peak device memory above the budget plus the allowance")

    with phase("polished streamed path"):
        # the streamed path's configuration (256 MiB, int8 stage 1) with
        # polish=True, stage 1 included; counts reset just before and read
        # just after
        svm_ps = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2, stream_config=cfg,
                        polish=True)
        for fn in (gram_kernel, gram_q8_kernel, smo_epoch_kernel):
            fn.launches = 0
        t0 = time.perf_counter()
        svm_ps.fit(xtr, ytr)
        pred_ps = svm_ps.predict(xte)
        wall_ps = time.perf_counter() - t0
        ps_launches = {"gram": gram_kernel.launches, "gram_q8": gram_q8_kernel.launches,
                       "smo_epoch": smo_epoch_kernel.launches}
        st_ps = svm_ps.stats
        ptr = st_ps.polish_trace
        accounted = polish_levels(ptr)
        print(f"route: stage 1 streamed {st_ps.stage1_streamed}, coarse levels "
              f"{['streamed' if lv.streamed else 'monolithic' for lv in ptr.levels[:-1]]}, "
              f"final level streamed {ptr.final.streamed}; launches {ps_launches}; the "
              f"levels account for {accounted} B2 launches; stage1 "
              f"{st_ps.stage1_seconds:.3f} s, stage2 {st_ps.stage2_seconds:.3f} s, "
              f"fit -> predict wall {wall_ps:.3f} s")
        check(st_ps.polished and st_ps.stage1_streamed, "the polished fit did not stream "
              "stage 1 or run the ladder")
        check(ptr.final.streamed and st_ps.stage2_streamed
              and st_ps.stage2_stats is ptr.final.stream_stats is not None,
              "the final level did not stream, or its stream stats are missing")
        check(ps_launches["gram_q8"] == st_ps.stage1_stats.chunks > 1,
              "B3 was not launched once per stage-1 chunk")
        check(ps_launches["smo_epoch"] == accounted > 0
              and all(int(lv.epochs.max()) > 0 for lv in ptr.levels),
              "B2 launches differ from the levels' epochs and blocks")
        cold_p5 = solve_batch_streamed(svm_s.factor.G, svm_s.tasks_, dataclasses.replace(
            svm_s.config, full_pass_period=svm_ps.polish_schedule.stream_full_pass_period),
            stream_config=cfg)
        G_check = svm_ps.factor.G.to(dev)      # for the checks only
        against_cold(svm_ps, svm_s, G_check, pred_ps, pred_s, "polished streamed path",
                     cold_p5)
        del G_check, cold_p5

    with phase("trace, streamed path"):
        # the streamed path's fit under a tracer: device work as CUDA-event
        # spans on the card's rows, resolved when read
        from repro_torch.core import trace as trace_mod
        tr = trace_mod.Tracer()
        svm_t = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2, stream_config=cfg)
        for fn in (gram_kernel, gram_q8_kernel, smo_epoch_kernel):
            fn.launches = 0
        t0 = time.perf_counter()
        svm_t.fit(xtr, ytr, trace=tr)
        wall_t = time.perf_counter() - t0
        t_launches = {"gram": gram_kernel.launches, "gram_q8": gram_q8_kernel.launches,
                      "smo_epoch": smo_epoch_kernel.launches}
        st_t = svm_t.stats
        t1, t2 = st_t.stage1_stats, st_t.stage2_stats
        same_t = (torch.equal(svm_t.factor.G, fac_s.G) and torch.equal(svm_t.alpha_, svm_s.alpha_)
                  and torch.equal(svm_t.W_, svm_s.W_)
                  and np.array_equal(st_t.epochs, st.epochs)
                  and t2.epoch_bytes == s2.epoch_bytes and t1.bytes_h2d == s1.bytes_h2d)
        t_read = time.perf_counter()
        evs = tr.events()
        t_read = time.perf_counter() - t_read
        rows = tr.device_tids()
        fit_sp = {e[2]: e for e in evs if e[1] == "fit"}
        s2_lo, s2_hi = fit_sp["stage2"][3], fit_sp["stage2"][3] + fit_sp["stage2"][4]
        dev_evs = [e for e in evs if e[5] in rows]
        b2 = [e for e in dev_evs if e[2] == "smo_block"]
        b2_sec = sum(e[4] for e in b2)
        copies2 = [e for e in dev_evs if e[2] == "copy_block"]
        b2_iv = trace_mod._merge_intervals([(e[3], e[3] + e[4]) for e in b2])
        copy_sec = sum(e[4] for e in copies2)
        under = sum(trace_mod._overlap_with(e[3], e[3] + e[4], b2_iv) for e in copies2)
        busy2, gaps2 = tr.busy("cuda:0 compute", s2_lo, s2_hi)
        print(tr.summary())
        print(f"traced fit: {len(evs)} events ({len(dev_evs)} device spans on "
              f"{sorted(rows.values())}), resolved in {t_read:.3f} s; stage1 "
              f"{st_t.stage1_seconds:.3f} s, stage2 {st_t.stage2_seconds:.3f} s against "
              f"the untraced {st.stage1_seconds:.3f} / {st.stage2_seconds:.3f} s "
              f"(fit wall {wall_t:.3f} s); launches {t_launches}; bit-equal to the "
              f"untraced fit {same_t}")
        print(f"stage 2: wall {s2_hi - s2_lo:.3f} s, B2 device {b2_sec:.3f} s over "
              f"{len(b2)} spans ({b2_sec / (s2_hi - s2_lo):.3f} of the wall); H2D copies "
              f"{copy_sec:.3f} s device time, {under:.3f} s of it under B2 "
              f"({under / max(copy_sec, 1e-12):.3f}); compute row busy {busy2:.3f} s, "
              f"idle share {1 - busy2 / (s2_hi - s2_lo):.3f}, largest gaps "
              f"{[round(b - a, 4) for a, b in gaps2[:5]]} s")
        print(f"stage 2 host: put {t2.put_seconds:.3f} s, drain {t2.drain_seconds:.3f} s, "
              f"compaction {t2.compact_seconds:.3f} s, copies {t2.h2d_seconds:.3f} s at "
              f"{t2.h2d_gbps:.2f} GB/s, device overlap of every H2D copy "
              f"{tr.overlap_efficiency(device=True):.3f}")
        check(same_t, "the traced fit is not bit-equal to the untraced one")
        check(sorted(rows.values()) == ["cuda:0 compute", "cuda:0 h2d"],
              "the device spans are not on the compute and H2D rows")
        check(len(b2) == t2.kernel_calls == t_launches["smo_epoch"],
              "B2's device spans differ from its launches")
        check(all(s2_lo - 1e-3 <= e[3] <= s2_hi for e in b2),
              "a B2 span lies outside stage 2's span")
        check(abs(sum(e[4] for e in dev_evs if e[1] == "h2d") - t1.h2d_seconds
                  - t2.h2d_seconds) <= 1e-6 * (t1.h2d_seconds + t2.h2d_seconds) + 1e-9,
              "the H2D copy spans do not sum to the stages' h2d_seconds")
        with tempfile.TemporaryDirectory() as td:
            out_json = os.path.join(td, "trace.json")
            tr.export(out_json)
            nbytes = os.path.getsize(out_json)
            with open(out_json) as f:
                loaded = json.load(f)["traceEvents"]
        print(f"exported {len(loaded)} trace events, {nbytes} B")
        check(sum(e["ph"] != "M" for e in loaded) == len(evs), "the exported trace lost events")
        del svm_t, evs, dev_evs, loaded
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            err_t = driver.main(["--classes", "3", "--n", "400", "--seq", "16",
                                 "--budget", "64", "--stream", "--trace-summary"])
        out_t = buf.getvalue()
        print(out_t, end="")
        check("trace summary (" in out_t and "device rows (CUDA events):" in out_t
              and "cuda:0 compute" in out_t and err_t < 1 - 1 / 3,
              "the driver's --trace-summary printed no device rows")

    with phase("streamed path, int8 blocks"):
        # stage 2 of the streamed path on its factor over the int8 wire
        cfg8 = dataclasses.replace(cfg, block_dtype="int8")
        svm8 = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2, stream_config=cfg8)
        smo_epoch_kernel.launches = 0
        base = peak_start()
        svm8.fit(xtr, ytr, factor=fac_s)
        peak8 = peak_since(base)
        i8_launches = smo_epoch_kernel.launches
        pred8 = svm8.predict(xte)
        b8 = svm8.stats.stage2_stats
        tile8 = b8.tile_rows
        eff8 = solver_stream.wire_group(tile8, cfg8)
        g8 = -(-n_tr // tile8) * (tile8 * rank + -(-tile8 // eff8) * 8)
        agree8 = float(np.mean(pred8 == pred_s))
        print(f"int8 blocks: tile {tile8} rows, groups of {eff8} rows; first full pass "
              f"{b8.epoch_bytes[0]} B against the int8 model {g8} and the f32 wire's "
              f"{g_bytes} ({b8.epoch_bytes[0] / g_bytes:.4f}); scales {b8.bytes_scales} B; "
              f"G bytes {b8.bytes_g} over {svm8.stats.epochs.max()} epochs (f32 wire "
              f"{s2.bytes_g} over {st.epochs.max()})")
        print(f"stage 2 {svm8.stats.stage2_seconds:.3f} s (f32 wire {st.stage2_seconds:.3f} "
              f"s): encode {b8.encode_seconds:.3f} s, put {b8.put_seconds:.3f} s, drain "
              f"{b8.drain_seconds:.3f} s, compaction {b8.compact_seconds:.3f} s, copies "
              f"{b8.h2d_seconds:.3f} s at {b8.h2d_gbps:.2f} GB/s; full passes "
              f"{b8.full_passes}, B2 launches {i8_launches}; test error "
              f"{float(np.mean(pred8 != yte)):.4f} (f32 wire {err_s:.4f}), agreement with "
              f"the f32 streamed fit {agree8:.4f}; largest violation "
              f"{float(svm8.stats.violations.max()):.3e}; peak device memory {peak8} B "
              f"(limit {limit2})")
        check(svm8.stats.stage2_streamed and b8.block_dtype == "int8",
              "the int8 wire did not stream stage 2")
        check(b8.epoch_bytes[0] == g8, "the first int8 pass is off the byte model")
        check(i8_launches == b8.kernel_calls > 0, "B2 launches differ from the int8 blocks")
        check(bool(np.all(svm8.stats.violations < 1e-2)), "an int8 task did not converge")
        check(peak8 <= limit2, "int8 stage 2 peak device memory above the budget "
              "plus the allowance")
        # a row decodes alike in every pass, so the int8 solve is the
        # monolithic solve on the decoded G, bit for bit
        t0 = time.perf_counter()
        codes8, table8 = quantize_rows(fac_s.G.numpy(), eff8)
        t_q = time.perf_counter() - t0
        Gd = dequant_rows(torch.from_numpy(codes8).to(dev), torch.from_numpy(table8).to(dev),
                          eff8)
        del codes8, table8
        mono8 = dual_solver.solve_batch(Gd, svm8.tasks_, svm8.config)
        del Gd
        same8 = (torch.equal(mono8.alpha, svm8.alpha_) and torch.equal(mono8.w, svm8.W_)
                 and np.array_equal(mono8.epochs.cpu().numpy(), svm8.stats.epochs))
        print(f"the int8 solve against the monolithic solve on the decoded G (G encoded "
              f"whole on the host in {t_q:.3f} s): alphas, w and epochs equal {same8}")
        check(same8, "the int8 stage 2 is not the monolithic solve on the decoded G")
        # The int8 fit solves another problem (the decoded G) to the same KKT
        # tol: its predictions are held to agree with the f32 fit's no less
        # than the f32 solve's own tolerance moves them (INT8_MIN_AGREE), and
        # its test error within the streamed path's 0.5 points of the f32
        # wire's.
        check(agree8 >= INT8_MIN_AGREE,
              f"int8-block predictions agree {agree8} < {INT8_MIN_AGREE}")
        check(abs(float(np.mean(pred8 != yte)) - err_s) <= 0.005,
              "int8-block test error off by > 0.5 points")
        del svm8, mono8

    with phase("streamed path, block cache"):
        # stage 2 of the streamed path (f32 wire) on its factor with the
        # block cache: 480 MiB less the 224 MiB carved for the cache leaves
        # the 256 MiB of the uncached fit to the blocks in flight
        cfg_c = StreamConfig(device_budget_bytes=480 << 20, cache_budget_bytes=224 << 20,
                             prefetch=2, autotune_prefetch=False)
        mono_c = solver_stream.stage2_monolithic_bytes(n_tr, rank, T, n_pad)
        tile_c = solver_stream.auto_tile_rows(n_tr, rank, T, cfg_c)
        blk_c = block_cache.block_wire_nbytes(tile_c, rank, "f32", 1)
        derived = block_cache.stage2_cache_budget(rank, T, s2.tile_rows, cfg.prefetch, cfg)
        print(f"byte model: the monolithic stage 2 {mono_c} B against the budget "
              f"{cfg_c.device_budget_bytes} B; tile {tile_c} rows (the uncached fit's "
              f"{s2.tile_rows}); a block {blk_c} B, the cache {cfg_c.cache_budget_bytes} B = "
              f"{cfg_c.cache_budget_bytes / blk_c:.3f} blocks; the streamed path's derived "
              f"cache budget {derived} B, its hits {s2.bytes_hit} B")
        check(mono_c > cfg_c.device_budget_bytes, "the cached stage 2 would not stream")
        check(s2.bytes_hit == 0 and s2.bytes_miss > 0 and derived < blk_c,
              "the streamed path's derived cache holds a block")
        svm_c = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2, stream_config=cfg_c)
        smo_epoch_kernel.launches = 0
        base = peak_start()
        svm_c.fit(xtr, ytr, factor=fac_s)
        peak_c = peak_since(base)
        cache_launches = smo_epoch_kernel.launches
        sc_ = svm_c.stats.stage2_stats
        limit_c = cfg_c.device_budget_bytes + allow2
        same_c = (torch.equal(svm_c.alpha_, svm_s.alpha_) and torch.equal(svm_c.W_, svm_s.W_)
                  and np.array_equal(svm_c.stats.epochs, st.epochs))
        cheap = [(h, m) for h, m in zip(sc_.epoch_hit_bytes, sc_.epoch_miss_bytes) if h + m]
        cheap_rate = sum(h for h, _ in cheap) / max(1, sum(h + m for h, m in cheap))
        warm_cheap = sum(1 for h, m in cheap if m == 0)
        print(f"cached stage 2: tile {sc_.tile_rows} rows, {svm_c.stats.stage2_seconds:.3f} s "
              f"(uncached {st.stage2_seconds:.3f} s); G bytes {sc_.bytes_g} (uncached "
              f"{s2.bytes_g}, {sc_.bytes_g / s2.bytes_g:.4f}x); hits {sc_.cache_hits} blocks "
              f"{sc_.bytes_hit} B, misses {sc_.cache_misses} blocks {sc_.bytes_miss} B, "
              f"evictions {sc_.cache_evictions}, peak resident {sc_.cache_resident_bytes} B; "
              f"cheap epochs' hit rate {cheap_rate:.4f} over {len(cheap)} cheap epochs "
              f"({warm_cheap} with no miss); copies {sc_.h2d_seconds:.3f} s (uncached "
              f"{s2.h2d_seconds:.3f} s), compaction {sc_.compact_seconds:.3f} s (uncached "
              f"{s2.compact_seconds:.3f} s); active_history {sc_.active_history}; B2 "
              f"launches {cache_launches}; peak device memory {peak_c} B (limit {limit_c}); "
              f"alphas, w and epochs equal to the uncached fit's {same_c}")
        check(svm_c.stats.stage2_streamed, "the cached stage 2 did not stream")
        check(same_c, "the cached stage 2 is not the uncached one bit for bit")
        check(sc_.bytes_hit + sc_.bytes_miss == s2.bytes_miss,
              "hits + misses differ from the uncached fit's compacted bytes")
        check(sc_.bytes_h2d == s2.bytes_h2d - sc_.bytes_hit,
              "the cached fit's H2D bytes are not the uncached less the hits")
        check(sc_.bytes_hit > 0, "the cache served no block")
        check(sc_.cache_resident_bytes <= cfg_c.cache_budget_bytes,
              "the cache's residency above its budget")
        check(peak_c <= limit_c, "cached stage 2 peak device memory above the budget "
              "plus the allowance")
        check(cache_launches == sc_.kernel_calls == sc_.blocks_streamed + sc_.cache_hits,
              "B2 launches differ from the blocks shipped and served")

        # the same under a tracer: the compute row's idle share in stage 2
        from repro_torch.core import trace as trace_mod
        tr_c = trace_mod.Tracer()
        svm_ct = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2, stream_config=cfg_c)
        svm_ct.fit(xtr, ytr, factor=fac_s, trace=tr_c)
        evs_c = tr_c.events()
        sp2 = [e for e in evs_c if e[1] == "fit" and e[2] == "stage2"][0]
        lo_c, hi_c = sp2[3], sp2[3] + sp2[4]
        busy_c, gaps_c = tr_c.busy("cuda:0 compute", lo_c, hi_c)
        rows_c = tr_c.device_tids()
        dev_c = [e for e in evs_c if e[5] in rows_c]
        b2_c = sum(e[4] for e in dev_c if e[2] == "smo_block")
        cp_c = sum(e[4] for e in dev_c if e[2] == "copy_block")
        n_hit = sum(1 for e in evs_c if e[1] == "cache" and e[2] == "hit")
        print(f"traced cached stage 2: wall {hi_c - lo_c:.3f} s, B2 device {b2_c:.3f} s, H2D "
              f"copies {cp_c:.3f} s device time, compute row busy {busy_c:.3f} s, idle share "
              f"{1 - busy_c / (hi_c - lo_c):.3f}, largest gaps "
              f"{[round(b - a, 4) for a, b in gaps_c[:5]]} s; {n_hit} hit instants; bit-equal "
              f"to the untraced cached fit "
              f"{torch.equal(svm_ct.alpha_, svm_c.alpha_) and torch.equal(svm_ct.W_, svm_c.W_)}")
        check(torch.equal(svm_ct.alpha_, svm_c.alpha_) and torch.equal(svm_ct.W_, svm_c.W_),
              "the traced cached fit is not the untraced one")
        check(n_hit == svm_ct.stats.stage2_stats.cache_hits > 0,
              "the trace's hit instants differ from the cache's hits")
        del svm_ct, evs_c, dev_c, tr_c

        # reduced (6000 x 784, B 512): every wire, an evicting budget, the farm
        xr6, yr6 = make_multiclass(6000, p=784, n_classes=10, sep=0.1, within=0.06, seed=1)
        _, lab6 = np.unique(yr6, return_inverse=True)
        kp6 = KernelParams("rbf", gamma=median_gamma(xr6))
        fac6 = compute_factor(xr6, kp6, 512, seed=0, device=dev)
        G6 = host_buffer(tuple(fac6.G.shape), torch.float32, dev).copy_(fac6.G)
        rank6 = G6.shape[1]
        t6, _ = build_ovo_tasks(lab6, 10, 1.0, device=dev)
        cfg6 = SolverConfig(tol=1e-3, max_epochs=600)
        base6 = dict(tile_rows=512, prefetch=2, autotune_prefetch=False)

        def pair6(**kw):
            on = solve_batch_streamed(G6, t6, cfg6, return_stats=True,
                                      stream_config=StreamConfig(**base6, **kw))
            off = solve_batch_streamed(G6, t6, cfg6, return_stats=True, stream_config=
                                       StreamConfig(**base6, **dict(kw, cache_blocks=False)))
            same = all(torch.equal(getattr(on[0], f), getattr(off[0], f))
                       for f in ("alpha", "w", "epochs", "violation"))
            return on[1], off[1], same

        for wire6 in ("f32", "bf16", "int8"):
            s_on, s_off, same6 = pair6(block_dtype=wire6)
            print(f"reduced, {wire6} blocks: epochs {s_on.epochs}, active_history "
                  f"{s_on.active_history}; G bytes {s_on.bytes_g} (uncached {s_off.bytes_g}); "
                  f"hits {s_on.cache_hits} ({s_on.bytes_hit} B), misses {s_on.cache_misses}; "
                  f"bit-equal to the uncached solve {same6}")
            check(same6, f"the cached {wire6} solve is not the uncached one")
            check(s_on.bytes_hit > 0 and s_on.bytes_hit + s_on.bytes_miss == s_off.bytes_miss,
                  f"the {wire6} cache served nothing or its bytes do not add up")
        tight = 2 * block_cache.block_wire_nbytes(512, rank6, "f32", 1)
        s_on, s_off, same6 = pair6(cache_budget_bytes=tight)
        print(f"reduced, a cache of two blocks ({tight} B): hits {s_on.cache_hits}, misses "
              f"{s_on.cache_misses}, evictions {s_on.cache_evictions}, peak resident "
              f"{s_on.cache_resident_bytes} B; bit-equal to the uncached solve {same6}")
        check(same6 and s_on.cache_resident_bytes <= tight,
              "the two-block cache is not exact or holds more than its budget")
        check(s_on.cache_misses > 0 and s_on.bytes_hit > 0,
              "the two-block cache did not serve and miss")
        grid6 = {}
        for on in (True, False):
            grid6[on] = cv.grid_search(xr6, yr6, [kp6.gamma], [1 / 16, 1 / 4], budget=512,
                                       folds=3, device=dev, stream=True, farm=True,
                                       config=SolverConfig(tol=1e-2),
                                       stream_config=StreamConfig(
                                           device_budget_bytes=256 << 20, prefetch=2,
                                           autotune_prefetch=False, cache_blocks=on))
        fs_on, fs_off = grid6[True].stream_stats[0], grid6[False].stream_stats[0]
        same_g = (np.array_equal(grid6[True].errors, grid6[False].errors)
                  and all(np.array_equal(a.epochs, b.epochs)
                          for a, b in zip(grid6[True].cells, grid6[False].cells)))
        print(f"reduced grid task farm ({len(grid6[True].cells)} cells): "
              f"errors {grid6[True].errors.tolist()}, G bytes {fs_on.bytes_g} (uncached "
              f"{fs_off.bytes_g}), hits {fs_on.cache_hits} ({fs_on.bytes_hit} B); errors and "
              f"epochs equal to the uncached farm's {same_g}")
        check(same_g, "the cached grid farm is not the uncached one")
        check(fs_on.bytes_hit + fs_on.bytes_miss == fs_off.bytes_miss,
              "the farm's hit and miss bytes do not add up")
        del fac6, G6, t6, grid6

    with phase("checkpoint and resume, streamed path"):
        # the cached stage 2 above with a snapshot every 5 full passes; a
        # kill at the third snapshot's boundary, then the resume
        ck_root = tempfile.TemporaryDirectory()
        ck2 = os.path.join(ck_root.name, "stage2")
        cfg_k = dataclasses.replace(cfg_c, checkpoint_dir=ck2, checkpoint_every=5)
        kill_at = 20 * 14                 # the 15th full pass (period 20, no ladder)
        faults.install(faults.FaultPlan().add("epoch_boundary", kind="kill", epoch=kill_at))
        killed = False
        t0 = time.perf_counter()
        try:
            LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2,
                   stream_config=cfg_k).fit(xtr, ytr, factor=fac_s)
        except faults.SimulatedKill:
            killed = True
        finally:
            faults.uninstall()
        t_killed = time.perf_counter() - t0
        snaps = sorted(f for f in os.listdir(ck2) if f.startswith("step_"))
        svm_r = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2,
                       stream_config=dataclasses.replace(cfg_k, resume=True))
        svm_r.fit(xtr, ytr, factor=fac_s)
        sr = svm_r.stats.stage2_stats
        same_r = (torch.equal(svm_r.alpha_, svm_c.alpha_) and torch.equal(svm_r.W_, svm_c.W_)
                  and np.array_equal(svm_r.stats.epochs, svm_c.stats.epochs)
                  and np.array_equal(svm_r.stats.violations, svm_c.stats.violations))
        sums_r = [b + h for b, h in zip(sr.epoch_bytes, sr.epoch_hit_bytes)]
        sums_c = [b + h for b, h in zip(sc_.epoch_bytes, sc_.epoch_hit_bytes)]
        # the uninterrupted run with the snapshots on, for their cost
        ck_full = os.path.join(ck_root.name, "full")
        svm_k = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2, stream_config=
                       dataclasses.replace(cfg_c, checkpoint_dir=ck_full, checkpoint_every=5))
        svm_k.fit(xtr, ytr, factor=fac_s)
        sk = svm_k.stats.stage2_stats
        print(f"killed at the boundary of epoch {kill_at} after {t_killed:.3f} s: {killed}; "
              f"snapshots on disk {snaps}; resumed from epoch {sr.resumed_from} in "
              f"{sr.resume_seconds:.3f} s, resumed stage 2 {svm_r.stats.stage2_seconds:.3f} s; "
              f"alphas, w, epochs and violations equal to the uninterrupted cached fit's "
              f"{same_r}; epoch_bytes + epoch_hit_bytes equal {sums_r == sums_c}; hits "
              f"{sr.bytes_hit} B (uninterrupted {sc_.bytes_hit} B)")
        print(f"snapshots every 5 full passes: {sk.snapshots} of {sk.snapshot_bytes} B each, "
              f"{sk.snapshot_seconds / max(1, sk.snapshots):.4f} s each; stage 2 "
              f"{svm_k.stats.stage2_seconds:.3f} s with them, {svm_c.stats.stage2_seconds:.3f} "
              f"s without; bit-equal {torch.equal(svm_k.W_, svm_c.W_)}")
        check(killed and len(snaps) == 3, "the kill did not land after the third snapshot")
        check(sr.resumed_from == kill_at + 1, "the resume did not start at the boundary")
        check(same_r, "the resumed stage 2 is not the uninterrupted one bit for bit")
        check(sums_r == sums_c, "the resumed epochs moved other compacted bytes")
        check(torch.equal(svm_k.W_, svm_c.W_) and sk.snapshots > 2,
              "snapshots changed the solve, or none were taken")

        # stage 1 on the int8 wire: killed at chunk 3 by an IO fault, resumed
        ck1 = os.path.join(ck_root.name, "stage1")
        cfg_1 = dataclasses.replace(cfg, checkpoint_dir=ck1)
        gram_q8_kernel.launches = 0
        faults.install(faults.FaultPlan().add("stage1", kind="io", chunk=3))
        io_hit = False
        try:
            compute_factor(xtr, kp, budget, seed=0, device=dev, stream_config=cfg_1)
        except OSError:
            io_hit = True
        finally:
            faults.uninstall()
        t0 = time.perf_counter()
        fac_r1 = compute_factor(xtr, kp, budget, seed=0, device=dev,
                                stream_config=dataclasses.replace(cfg_1, resume=True))
        t_r1 = time.perf_counter() - t0
        s1r = fac_r1.stage1_stats
        same_g1 = torch.equal(fac_r1.G, fac_s.G)
        print(f"stage 1 (int8 wire) killed at chunk 3: {io_hit}; resumed in {t_r1:.3f} s: "
              f"{s1r.chunks_skipped} chunks ({s1r.rows_resumed} rows) read back, "
              f"{s1r.chunks} computed (B3 launches {gram_q8_kernel.launches}); G bit-equal "
              f"to the streamed path's {same_g1}")
        check(io_hit and s1r.chunks_skipped >= 1 and same_g1,
              "the resumed stage 1 skipped nothing or its G differs")
        del fac_r1, svm_r, svm_k

        # the driver at a reduced size: SIGKILL once a snapshot exists, then --resume
        xk, yk = make_multiclass(3000, p=16, n_classes=6, seed=0)
        lib_k = os.path.join(ck_root.name, "train.svm")
        write_libsvm(lib_k, xk, yk)
        ckd = os.path.join(ck_root.name, "driver")
        argv_k = [sys.executable, "-m", "repro_torch.launch.train_svm", "--libsvm", lib_k,
                  "--budget", "128", "--gamma", "0.25", "--C", "64", "--chunk-rows", "512",
                  "--tile-rows", "256", "--checkpoint-dir", ckd, "--checkpoint-every", "1"]
        env_k = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv_k, env=env_k, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        try:
            while time.perf_counter() - t0 < 120 and proc.poll() is None:
                if os.path.isdir(ckd) and any(f.startswith("step_") for f in os.listdir(ckd)):
                    proc.send_signal(signal.SIGKILL)
                    break
                time.sleep(0.005)
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        rc_k = proc.returncode
        out_k = subprocess.run(argv_k + ["--resume"], env=env_k, capture_output=True,
                               text=True, timeout=180)
        print(f"driver killed with SIGKILL (exit {rc_k}) after {time.perf_counter() - t0:.1f} "
              f"s; --resume exit {out_k.returncode}:")
        print(out_k.stdout, end="")
        check(rc_k == -signal.SIGKILL, "the driver ended before it could be killed")
        check(out_k.returncode == 0 and "resuming" in out_k.stdout
              and "train error" in out_k.stdout, "the driver's --resume failed")
        ck_root.cleanup()

    with phase("windowed B2 vs plain"):
        # block 1 of the streamed grid (row0 = tile), every task from zero
        tile = s2.tile_rows
        row0 = tile if n_tr > tile else 0
        blk = fac_s.G[row0:row0 + tile].to(dev)
        tasks_s = svm_s.tasks_
        idx_h, c_h = tasks_s.idx.cpu().numpy(), tasks_s.c.cpu().numpy()
        bw = np.stack([block_windows(idx_h[t][c_h[t] > 0], tile, -(-n_tr // tile))
                       for t in range(T)])[:, row0 // tile:row0 // tile + 2]
        win = dict(lo=torch.as_tensor(bw[:, 0], dtype=torch.int32, device=dev),
                   hi=torch.as_tensor(bw[:, 1], dtype=torch.int32, device=dev),
                   row0=row0)
        state_w = dict(G=blk, q=(blk * blk).sum(-1), idx=tasks_s.idx, y=tasks_s.y,
                       c=tasks_s.c, alpha=torch.zeros((T, n_pad), device=dev),
                       unchanged=torch.zeros((T, n_pad), dtype=torch.int32, device=dev),
                       w=torch.zeros((T, rank), device=dev),
                       live=torch.ones(T, dtype=torch.bool, device=dev))
        visits = int((bw[:, 1] - bw[:, 0]).sum())
        smo_err = max(smo_err, compare_smo(
            state_w, True, f"windowed, block rows {row0}:{row0 + blk.shape[0]}, "
            f"{visits} task rows", **win))

    with phase("timing, streamed kernels"):
        q8_ms = cuda_ms(lambda: gram_q8_kernel(v_d, sc_d, lm, kp, group), 10)
        q8_plain = cuda_ms(lambda: gram_q8_plain(v_d, sc_d, lm, kp, group), 10)

        def q8_library():   # dequantise, cuBLAS fp32 product, the RBF epilogue
            rep = sc_d.repeat_interleave(group, 0)[:chunk]
            xs = v_d.float() * rep[:, :1] + rep[:, 1:]
            xsq = (xs * xs).sum(-1)
            zsq = (lm * lm).sum(-1)
            k = torch.addmm(xsq[:, None], xs, lm.T, alpha=-2.0)
            return k.add_(zsq[None, :]).clamp_min_(0.0).mul_(-kp.gamma).exp_()
        q8_lib = cuda_ms(q8_library, 10)
        xc_d = torch.as_tensor(xtr[:chunk], device=dev)
        b1_chunk = cuda_ms(lambda: gram_kernel(xc_d, lm, kp), 10)
        q8_bound, q8_by = gram_q8_bound(chunk, budget, p_tr, sc.shape[0])
        q8_bound_cc, _ = gram_q8_bound_cuda_cores(chunk, budget, p_tr, sc.shape[0])
        q8_b2b = cuda_ms_back_to_back(lambda: gram_q8_kernel(v_d, sc_d, lm, kp, group), 50)
        print(f"gram_q8 {chunk}x{budget}x{p_tr}: {q8_ms:.4f} ms alone, {q8_b2b:.4f} back "
              f"to back (plain {q8_plain:.3f}, library {q8_lib:.3f}, bound {q8_bound:.4f} "
              f"by {q8_by} for 3 bf16 passes on the tensor cores, {q8_bound_cc:.3f} as one "
              f"fp32 pass on the CUDA cores; {100 * q8_bound / q8_ms:.1f}% of the bound); "
              f"B1 on the same chunk in fp32 {b1_chunk:.3f} ms")
        check(torch.allclose(q8_library(), gram_q8_plain(v_d, sc_d, lm, kp, group),
                             rtol=GRAM_RTOL, atol=GRAM_ATOL),
              "the B3 library yardstick computes another function")

        wb_ms = cuda_ms(run(smo_epoch_kernel, True, **win), 5, reset(state_w))
        changed_w = int((work["alpha"] != 0).sum())
        wb_plain = cuda_ms(run(smo_epoch_plain, True, **win), 1, reset(state_w))
        g_rows_w = blk.shape[0]
        wb_bound, wb_by = bound_ms(
            2.0 * rank * visits + 2.0 * rank * changed_w,
            4.0 * (g_rows_w * rank + g_rows_w + 7 * visits + 2 * T * rank + 3 * T))
        print(f"windowed smo, one full-pass block of {g_rows_w} rows, {visits} task "
              f"rows: {wb_ms:.3f} ms (plain {wb_plain:.1f}, bound {wb_bound:.4f} "
              f"by {wb_by})")

    with phase("streamed stage 1 at scale"):
        need = 32 << 30
        avail = host_free_bytes()
        print(f"host MemAvailable {avail} B (this phase needs about {need})")
        check(avail >= need, "not enough host memory for the 1,000,000-row phase")
        t0 = time.perf_counter()
        xb = multiclass_on_card(1_000_000, 784, 10, 0.07, 0.06, 1, dev)
        kpb = KernelParams("rbf", gamma=median_gamma(xb))
        print(f"data {xb.shape} in {time.perf_counter() - t0:.3f} s, gamma "
              f"{kpb.gamma:.6e}")
        sample = np.sort(np.random.default_rng(0).choice(len(xb), 4096, replace=False))
        scale = {}
        for wire in ("f32", "int8"):
            gram_kernel.launches = 0
            gram_q8_kernel.launches = 0
            t0 = time.perf_counter()
            f = compute_factor_streamed(xb, kpb, budget,
                                        config=StreamConfig(stage1_dtype=wire),
                                        device=dev)
            secs = time.perf_counter() - t0
            b_launches = {"gram": gram_kernel.launches,
                          "gram_q8": gram_q8_kernel.launches}
            s1b = f.stage1_stats
            rows = f.G[sample].clone()
            print(f"stage 1 at scale, {wire} wire: {secs:.3f} s (pipeline "
                  f"{s1b.seconds:.3f} s, pinned G alloc {s1b.alloc_seconds:.3f} s, "
                  f"encode {s1b.encode_seconds:.3f} s, put {s1b.put_seconds:.3f} s, "
                  f"drain {s1b.drain_seconds:.3f} s); chunks {s1b.chunks}, rank "
                  f"{f.effective_rank}, bytes_h2d {s1b.bytes_h2d} (scales "
                  f"{s1b.bytes_scales}), h2d {s1b.h2d_gbps:.2f} GB/s, overlap "
                  f"{s1b.overlap_efficiency:.3f}, prefetch_final {s1b.prefetch_final}; "
                  f"launches {b_launches}")
            check(f.G.is_pinned() and s1b.rows == len(xb)
                  and bool(torch.isfinite(rows).all()),
                  f"stage 1 at scale, {wire} wire: G not pinned, short or not finite")
            # K_mm goes through B1 once; every chunk through B1 (f32 wire) or
            # B3 (int8 wire) once
            want = ({"gram": 1 + s1b.chunks, "gram_q8": 0} if wire == "f32"
                    else {"gram": 1, "gram_q8": s1b.chunks})
            check(b_launches == want and s1b.chunks > 1,
                  f"stage 1 at scale, {wire} wire: launches {b_launches}, not {want}")
            scale[wire] = (rows, s1b.bytes_h2d)
            if wire == "f32":
                lm_b, proj_b = f.landmarks, f.projector
                # the sampled G rows against the plain path on the same
                # landmarks and projector: G - G_plain = (K - K_plain) P, so
                # the gram tolerance carried through |P| bounds each entry
                xs_d = torch.as_tensor(xb[sample], device=dev)
                ks_plain = gram_plain(xs_d, lm_b, kpb)
                gs_plain = ks_plain @ proj_b
                gs_tol = (GRAM_ATOL + GRAM_RTOL * ks_plain.abs()) @ proj_b.abs()
                gs_err = (rows.to(dev) - gs_plain).abs()
                print(f"f32 wire G rows vs plain path on {len(sample)} rows: max "
                      f"abs err {gs_err.max().item():.3e}, largest share of its "
                      f"bound {(gs_err / gs_tol).max().item():.3e} (max 1), plain G "
                      f"in [{gs_plain.min().item():.3e}, {gs_plain.max().item():.3e}]")
                check(bool((gs_err <= gs_tol).all()),
                      "stage 1 at scale: G rows disagree with the plain path")
                del xs_d, ks_plain, gs_plain, gs_tol, gs_err
            del f
        # B1 and B3 against their plain versions at this path's chunk shape,
        # on its first chunk as each wire carries it
        cfg_b = StreamConfig()
        chunk_b = auto_chunk_rows(len(xb), xb.shape[1], budget, cfg_b)
        xc_d = torch.as_tensor(xb[:chunk_b], device=dev)
        gram_err = max(gram_err, compare_gram(
            xc_d, lm_b, kpb, f"stage-1 chunk at scale {chunk_b}x{budget}x{xb.shape[1]}"))
        b1b_ms = cuda_ms(lambda: gram_kernel(xc_d, lm_b, kpb), 10)
        b1b_b2b = cuda_ms_back_to_back(lambda: gram_kernel(xc_d, lm_b, kpb), 50)
        b1b_bound, _ = gram_bound(chunk_b, budget, xb.shape[1])
        print(f"gram at scale {chunk_b}x{budget}x{xb.shape[1]}: {b1b_ms:.4f} ms alone, "
              f"{b1b_b2b:.4f} back to back (bound {b1b_bound:.4f}; "
              f"{100 * b1b_bound / b1b_b2b:.1f}% of it back to back)")
        del xc_d
        v, sc = quantize_rows(xb[:chunk_b], cfg_b.quant_group_rows, symmetric=True)
        vb_d, scb_d = torch.as_tensor(v, device=dev), torch.as_tensor(sc, device=dev)
        g_b = cfg_b.quant_group_rows
        q8_err = max(q8_err, compare_gram_q8(
            vb_d, scb_d, lm_b, kpb, g_b,
            f"stage-1 chunk at scale {chunk_b}x{budget}x{xb.shape[1]}"))
        q8b_ms = cuda_ms(lambda: gram_q8_kernel(vb_d, scb_d, lm_b, kpb, g_b), 10)
        q8b_plain = cuda_ms(lambda: gram_q8_plain(vb_d, scb_d, lm_b, kpb, g_b), 3)
        q8b_bound, q8b_by = gram_q8_bound(chunk_b, budget, xb.shape[1], sc.shape[0])
        q8b_bound_cc, _ = gram_q8_bound_cuda_cores(chunk_b, budget, xb.shape[1], sc.shape[0])
        print(f"gram_q8 at scale {chunk_b}x{budget}x{xb.shape[1]}: {q8b_ms:.4f} ms (plain "
              f"{q8b_plain:.3f}, bound {q8b_bound:.4f} by {q8b_by} for 3 bf16 passes, "
              f"{q8b_bound_cc:.3f} as one fp32 pass on the CUDA cores; "
              f"{100 * q8b_bound / q8b_ms:.1f}% of the bound)")
        del vb_d, scb_d
        d = (scale["int8"][0] - scale["f32"][0]).abs()
        print(f"int8 G vs f32 G on {len(sample)} rows: max abs diff "
              f"{d.max().item():.3e} (max 0.05), mean {d.mean().item():.3e} (max "
              f"0.005); wire bytes int8 {scale['int8'][1]} vs f32 {scale['f32'][1]}")
        check(d.max().item() < 0.05 and d.mean().item() < 0.005,
              "the int8 factor left the codec bounds of the f32 factor")
        check(3 * scale["int8"][1] < scale["f32"][1], "int8 wire not below f32 / 3")

    with phase("streamed vs monolithic, one factor"):
        # the main path's own f32 factor in pinned host memory, through the
        # streamed stage 2 at the streamed path's budget, against the main
        # path's solve_batch on the card: the same sweep order and the same
        # q make the same epochs and alphas
        G_d = fac.G
        G_h = host_buffer(tuple(G_d.shape), torch.float32, dev).copy_(G_d)
        res_m, s2m = solve_batch_streamed(G_h, svm.tasks_, svm.config,
                                          stream_config=cfg, return_stats=True)
        # q as the streamed solve sums it (each block of its grid, plus a
        # block shorter than 16 rows and one with a short tail) against
        # solve_batch's (G * G).sum(-1)
        q_mono = (G_d * G_d).sum(-1)
        tile_m = s2m.tile_rows
        spans = [(s, min(s + tile_m, n_tr)) for s in range(0, n_tr, tile_m)]
        q_err = 0.0
        for s, e in spans + [(8, 15), (16, 16 + 1029)]:
            q_blk = torch.empty((e - s,), device=dev)
            _row_sq(G_d[s:e], q_blk)
            q_err = max(q_err, (q_blk - q_mono[s:e]).abs().max().item())
        a_err = (res_m.alpha - svm.alpha_).abs().max().item()
        w_err = (res_m.w - svm.W_).abs().max().item()
        dual_m = svm.alpha_.sum(-1) - 0.5 * (svm.W_ * svm.W_).sum(-1)
        rel = ((res_m.dual_obj - dual_m).abs() / dual_m.abs()).max().item()
        ep_s, ep_m = res_m.epochs.cpu().numpy(), svm.stats.epochs
        bit_equal = (np.array_equal(ep_s, ep_m) and torch.equal(res_m.alpha, svm.alpha_)
                     and torch.equal(res_m.w, svm.W_))
        print(f"streamed stage 2 on the main path's factor ({s2m.seconds:.3f} s, "
              f"tile {tile_m}, {s2m.kernel_calls} B2 launches) vs its monolithic "
              f"solve: epochs max {ep_s.max()} vs {ep_m.max()}, equal "
              f"{np.array_equal(ep_s, ep_m)}; max |alpha diff| {a_err:.3e} (max "
              f"1e-6), max |w diff| {w_err:.3e}, dual objective max rel diff "
              f"{rel:.3e} (max 5e-3), bit-equal {bit_equal}; max |q streamed - "
              f"q monolithic| {q_err:.3e} over {len(spans) + 2} blocks")
        check(q_err == 0.0, "the streamed q differs from solve_batch's")
        check(np.array_equal(ep_s, ep_m) and a_err <= 1e-6 and rel <= 5e-3,
              "the streamed stage 2 left the monolithic trajectory")
        del G_h


    with phase("end-to-end driver, full width"):
        cfg_m = get_config("qwen3-0.6b")
        check(cfg_m.n_layers == 28 and cfg_m.d_model == 1024,
              "qwen3-0.6b is not at its published width and depth")
        t0 = time.perf_counter()
        backbone = init_model(torch.Generator(device=dev).manual_seed(0), cfg_m, device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in backbone.parameters())
        print(f"qwen3-0.6b: {cfg_m.n_layers} layers, d {cfg_m.d_model}, heads "
              f"{cfg_m.n_heads}/{cfg_m.n_kv_heads}, head dim {cfg_m.resolved_head_dim}, "
              f"{n_params} parameters (bf16) in {time.perf_counter() - t0:.3f} s")
        n_docs, seq, n_cls, feat_batch = 8000, 256, 10, 32
        toks, ydoc = class_conditioned_tokens(n_docs, n_cls, seq, cfg_m.vocab_size)
        n_tr = int(n_docs * 0.8)
        base = peak_start()
        for fn in (flash_attention_kernel, gram_kernel, gram_q8_kernel, smo_epoch_kernel):
            fn.launches = 0
        t0 = time.perf_counter()
        feats = extract_features(cfg_m, backbone, toks, batch=feat_batch)
        t_feat = time.perf_counter() - t0
        gamma_f = median_gamma(feats)
        head = LPDSVM(KernelParams("rbf", gamma=gamma_f), C=8.0, budget=1024, tol=1e-2)
        t0 = time.perf_counter()
        head.fit(feats[:n_tr], ydoc[:n_tr])
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred_f = head.predict(feats[n_tr:])
        t_pred = time.perf_counter() - t0
        e2e = {"flash_attention": flash_attention_kernel.launches,
               "gram": gram_kernel.launches, "gram_q8": gram_q8_kernel.launches,
               "smo_epoch": smo_epoch_kernel.launches}
        peak_e2e = peak_since(base)
        err_f = float(np.mean(pred_f != ydoc[n_tr:]))
        st_f = head.stats
        want_b4 = cfg_m.n_layers * -(-n_docs // feat_batch)
        print(f"features {feats.shape} in {t_feat:.3f} s ({n_docs * seq / t_feat:.0f} "
              f"tokens/s), range [{feats.min():.3e}, {feats.max():.3e}], gamma "
              f"{gamma_f:.6e}")
        print(f"head: fit {t_fit:.3f} s (stage1 {st_f.stage1_seconds:.3f} s, stage2 "
              f"{st_f.stage2_seconds:.3f} s, rank {st_f.effective_rank}, {st_f.n_tasks} "
              f"tasks, epochs max {st_f.epochs.max()}), predict {t_pred:.3f} s; test "
              f"error {err_f:.4f} (chance {1 - 1 / n_cls:.2f}); peak device memory "
              f"{peak_e2e} B above the weights")
        print(f"launches {e2e} (B4 expected {cfg_m.n_layers} x ceil({n_docs} / "
              f"{feat_batch}) = {want_b4})")
        check(feats.shape == (n_docs, cfg_m.d_model) and bool(np.isfinite(feats).all()),
              "features of the wrong shape or not finite")
        check(e2e["flash_attention"] == want_b4, "B4 launches differ from layers x batches")
        check(e2e["gram"] == 3 and e2e["gram_q8"] == 0,
              "B1 not launched once each for K_mm, K_nm and the predict features")
        check(e2e["smo_epoch"] == int(st_f.epochs.max()), "B2 launches differ from the epochs")
        check(set(np.unique(pred_f)) <= set(range(n_cls)), "predictions outside the classes")
        print(f"head tasks converged {int((st_f.violations < 1e-2).sum())} of {st_f.n_tasks}")

        # where the feature time goes: one batch of the trunk on the card,
        # B4 at its shape and the layer's seven bf16 products at theirs
        tb = torch.as_tensor(toks[:feat_batch], device=dev).long()
        with torch.no_grad():
            trunk_ms = cuda_ms(lambda: trunk(backbone, cfg_m, tb), 3)
            L0 = backbone.layers[0]
            rows = feat_batch * seq
            xa = torch.randn(rows, cfg_m.d_model, device=dev, dtype=torch.bfloat16)
            xo = torch.randn(rows, cfg_m.n_heads * cfg_m.resolved_head_dim, device=dev,
                             dtype=torch.bfloat16)
            xh = torch.randn(rows, cfg_m.d_ff, device=dev, dtype=torch.bfloat16)
            prods = ((xa, L0.mixer.wq), (xa, L0.mixer.wk), (xa, L0.mixer.wv),
                     (xo, L0.mixer.wo), (xa, L0.ffn.w_gate), (xa, L0.ffn.w_up),
                     (xh, L0.ffn.w_down))
            mm_ms = cuda_ms(lambda: [a @ w for a, w in prods], 10)
        b4_ms = flash_times["qwen3-0.6b pipeline"]["ms"]
        b4_b2b = flash_times["qwen3-0.6b pipeline"]["ms_back_to_back"]
        layer_b4, layer_mm = cfg_m.n_layers * b4_ms, cfg_m.n_layers * mm_ms
        batches = -(-n_docs // feat_batch)
        mm_flops = 2.0 * rows * sum(w.numel() for _, w in prods)
        print(f"feature time per batch of {feat_batch} x {seq}: trunk {trunk_ms:.3f} ms on "
              f"the card = B4 {layer_b4:.3f} ms ({100 * layer_b4 / trunk_ms:.1f}%: "
              f"{cfg_m.n_layers} x {b4_ms:.4f} alone; "
              f"{100 * cfg_m.n_layers * b4_b2b / trunk_ms:.1f}% at {b4_b2b:.4f} back to "
              f"back) + bf16 "
              f"products {layer_mm:.3f} ms ({cfg_m.n_layers} x {mm_ms:.3f}, "
              f"{mm_flops / mm_ms / 1e9:.0f} TFLOP/s) + rest "
              f"{trunk_ms - layer_b4 - layer_mm:.3f} ms; x {batches} batches = "
              f"{batches * trunk_ms / 1e3:.3f} s of {t_feat:.3f} s wall")
        del xa, xo, xh, tb

    with phase("backbone card vs cpu, 2 layers"):
        cfg2 = dataclasses.replace(cfg_m, n_layers=2)
        first2 = {k: v for k, v in backbone.state_dict().items()
                  if not k.startswith("layers.") or int(k.split(".")[1]) < 2}
        cut = {}
        for d in ("cuda", "cpu"):
            cut[d] = init_model(None, cfg2, device=d)
            cut[d].load_state_dict({k: v.to(d) for k, v in first2.items()})
        t0 = time.perf_counter()
        f_card = extract_features(cfg2, cut["cuda"], toks[:16])
        f_cpu = extract_features(cfg2, cut["cpu"], toks[:16])
        ferr = np.abs(f_card - f_cpu)
        print(f"2-layer qwen3-0.6b on 16 x {seq} tokens: card vs CPU features max abs "
              f"err {ferr.max():.3e} (tol {FEATURE_ATOL}), mean {ferr.mean():.3e} (tol "
              f"{FEATURE_MEAN_ATOL}), CPU features in [{f_cpu.min():.3e}, "
              f"{f_cpu.max():.3e}] ({time.perf_counter() - t0:.3f} s)")
        check(ferr.max() <= FEATURE_ATOL and ferr.mean() <= FEATURE_MEAN_ATOL,
              "the card's features disagree with the CPU's")

    with phase("class signal by depth"):
        # the same head on the same documents with 0 layers (the mean input
        # embedding) and with the 2-layer cut, beside the 28 layers above:
        # a random backbone over a 151936-token vocabulary dilutes the
        # documents' class signal layer by layer
        def head_error(f):
            s = LPDSVM(KernelParams("rbf", gamma=median_gamma(f)), C=8.0, budget=1024,
                       tol=1e-2).fit(f[:n_tr], ydoc[:n_tr])
            return float(np.mean(s.predict(f[n_tr:]) != ydoc[n_tr:]))
        with torch.no_grad():
            f0 = torch.cat([backbone.embed[torch.as_tensor(toks[i:i + feat_batch],
                                                           device=dev).long()]
                            .float().mean(1) for i in range(0, n_docs, feat_batch)])
        by_depth = {0: head_error(f0.cpu().numpy()),
                    2: head_error(extract_features(cfg2, cut["cuda"], toks)), 28: err_f}
        chance = 1 - 1 / n_cls
        # ten standard errors of a chance-level classifier on the test rows
        margin = 10 * (chance * (1 - chance) / (n_docs - n_tr)) ** 0.5
        print(f"head test error by backbone depth (chance {chance:.2f}): "
              + ", ".join(f"{d} layers {e:.4f}" for d, e in by_depth.items())
              + f"; 0 layers must be below {chance - margin:.4f}")
        check(by_depth[0] < chance - margin,
              "the documents' mean input embedding carries no class signal")
        del cut, backbone, f0

    with phase("driver --polish"):
        # the paper's driver through its CLI (the reduced backbone from seed
        # 0, as the reference's CLI builds it) with --polish, in a process
        # of its own
        argv = ["--classes", "3", "--n", "400", "--seq", "16", "--budget", "64", "--polish"]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train_svm", *argv],
                             cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        print(run.stdout.strip())
        levels = [l for l in run.stdout.splitlines() if l.startswith("polish level ")]
        found = re.search(r"test error: ([0-9.]+) \(chance ([0-9.]+)\)", run.stdout)
        print(f"train_svm {' '.join(argv)}: exit code {run.returncode}, "
              f"{len(levels)} polish level lines, {time.perf_counter() - t0:.3f} s")
        check(run.returncode == 0, f"the driver failed:\n{run.stderr[-4000:]}")
        check(len(levels) >= 1 and "polish total:" in run.stdout,
              "the driver printed no polish level lines")
        check(found is not None and float(found.group(1)) < float(found.group(2)),
              "the driver's polished head does not beat chance")

    # ---------------------------------------- model selection (core/cv.py)
    gcfg = SolverConfig(tol=1e-2, max_epochs=1000)     # LPDSVM's, at tol 1e-2
    Cs_main = [0.25, 1.0, 4.0]
    folds = 3
    chance = 0.9

    def grid_cells(grid, counts=None) -> None:
        """One line a cell; ``counts``: each cell's (B2 launches, _init_w s)."""
        for k, c in enumerate(grid.cells):
            st = c.stream_stats
            extra = (f", B2 launches {counts[k][0]}, _init_w {counts[k][1]:.4f} s"
                     if counts else "")
            if st is not None:
                extra += (f", streamed: {st.kernel_calls} B2 launches, bytes_g {st.bytes_g}, "
                          f"tile {st.tile_rows}, init pass {st.init_seconds:.4f} s")
            print(f"cell gamma {c.gamma:.6e} C {c.C:g}: T {c.n_tasks}, n_pad {c.n_pad}, "
                  f"epochs max {int(c.epochs.max())} mean {c.epochs.mean():.2f}{extra}, "
                  f"stage 2 {c.seconds:.4f} s, CV error {c.error:.4f}")

    def counted_grid(*args, **kw):
        """grid_search with each cell's B2 launches (the kernel's counter,
        read around the cell) and the seconds of its fp64 warm start
        (dual_solver._init_w, synchronised); every count reset just before."""
        counts, init_s = [], []
        solve_routed, init_w = cv._solve_routed, dual_solver._init_w

        def timed_init_w(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w = init_w(*a)
            torch.cuda.synchronize()
            init_s.append(time.perf_counter() - t0)
            return w

        def counted(*a, **k):
            before = smo_epoch_kernel.launches
            init_s.clear()
            out = solve_routed(*a, **k)
            counts.append((smo_epoch_kernel.launches - before, sum(init_s)))
            return out

        cv._solve_routed, dual_solver._init_w = counted, timed_init_w
        try:
            for fn in (gram_kernel, gram_q8_kernel, smo_epoch_kernel):
                fn.launches = 0
            t0 = time.perf_counter()
            grid = cv.grid_search(*args, **kw)
            wall = time.perf_counter() - t0
            total = {"gram": gram_kernel.launches, "gram_q8": gram_q8_kernel.launches,
                     "smo_epoch": smo_epoch_kernel.launches}
        finally:
            cv._solve_routed, dual_solver._init_w = solve_routed, init_w
        return grid, counts, total, wall

    with phase("grid search, main path"):
        # the main path's data and solver at full width: 3 gammas x 3 Cs x 3
        # folds x 45 pairs, one stage 1 per gamma, T = 135 tasks a cell
        gammas = [gamma / 2, gamma, 2 * gamma]
        grid, counts, g_launches, g_wall = counted_grid(
            xtr, ytr, gammas, Cs_main, budget=budget, folds=folds, config=gcfg, seed=0)
        grid_cells(grid, counts)
        print(f"grid {len(gammas)} gammas x {len(Cs_main)} Cs x {folds} folds: "
              f"{grid.n_binary_solved} binary SVMs, stage 1 {grid.stage1_seconds:.3f} s, "
              f"stage 2 {grid.stage2_seconds:.3f} s, wall {g_wall:.3f} s; launches "
              f"{g_launches}; best gamma {grid.best_gamma:.6e} C {grid.best_C:g} CV error "
              f"{grid.best_error:.4f}")
        check(grid.n_binary_solved == 1215, "the grid did not solve 1215 binary SVMs")
        check(len(grid.cells) == 9 and all(c.n_tasks == 135 for c in grid.cells),
              "a cell is not 3 folds x 45 pairs")
        check(g_launches["gram"] == 2 * len(gammas) and g_launches["gram_q8"] == 0,
              "B1 not launched twice (K_mm, K_nm) per gamma and never per cell")
        check(all(n == int(c.epochs.max()) > 0 for (n, _), c in zip(counts, grid.cells)),
              "a cell's B2 launches differ from its largest epoch count")
        check(sum(n for n, _ in counts) == g_launches["smo_epoch"],
              "B2 launched outside the cells")
        check(np.isfinite(grid.errors).all() and grid.best_error < chance,
              "the grid's best CV error is not below chance")
        g_i = 1                                    # gamma g's row
        cold, _, _, _ = counted_grid(xtr, ytr, [gamma], Cs_main, budget=budget, folds=folds,
                                     config=gcfg, seed=0, warm_start=False)
        ladder_diff = float(np.abs(cold.errors[0] - grid.errors[g_i]).max())
        print(f"gamma {gamma:.6e}: warm ladder CV errors {grid.errors[g_i].tolist()} stage 2 "
              f"{grid.per_cell_seconds[g_i].tolist()} s; cold {cold.errors[0].tolist()} "
              f"stage 2 {cold.per_cell_seconds[0].tolist()} s; largest difference "
              f"{ladder_diff:.4f} (max 0.03)")
        check(ladder_diff <= 0.03, "the cold ladder's CV errors stray from the warm ladder's")
        grid_smo_launches = g_launches["smo_epoch"]

    with phase("grid cell, held"):
        # one cell of the main-path grid (gamma g, C 1, cold) through
        # solve_batch on the card, on the main path's factor
        _, labels_tr = np.unique(ytr, return_inverse=True)
        masks = cv.kfold_masks(len(xtr), folds, 0)
        ctasks, _ = cv.build_cv_tasks(labels_tr, 10, 1.0, masks, device=dev)
        smo_epoch_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cres = dual_solver.solve_batch(fac.G, ctasks, gcfg)
        torch.cuda.synchronize()
        c_s = time.perf_counter() - t0
        real_c = ctasks.c > 0
        pad_zero = bool((cres.alpha[~real_c] == 0).all())
        in_box = bool(((cres.alpha >= 0) & (cres.alpha <= ctasks.c)).all())
        rows_t = real_c.sum(1)
        print(f"cell C 1: T {ctasks.n_tasks}, n_pad {ctasks.idx.shape[1]}, real rows "
              f"{int(rows_t.min())}..{int(rows_t.max())} a task; epochs max "
              f"{int(cres.epochs.max())}, {smo_epoch_kernel.launches} B2 launches, "
              f"{c_s:.3f} s; largest violation {cres.violation.max().item():.4g} (tol "
              f"{gcfg.tol}); alphas in their box {in_box}; padding alphas 0 {pad_zero}")
        check(bool((cres.violation < gcfg.tol).all()), "a cell's task ends above tol")
        check(in_box and pad_zero, "a cell's alpha left its box or a padding alpha moved")
        check(smo_epoch_kernel.launches == int(cres.epochs.max()),
              "the cell's B2 launches differ from its epochs")
        # B2 at T = 135 on the main path's factor: a full epoch from zero and
        # a cheap epoch from the solved cell, as the timing phase at T = 45
        Tc, n_pad_c = ctasks.idx.shape
        T45, n_pad45 = svm.tasks_.idx.shape
        live_c = torch.ones(Tc, dtype=torch.bool, device=dev)
        cv0 = smo_state(G, ctasks, torch.zeros((Tc, n_pad_c), device=dev),
                        torch.zeros((Tc, n_pad_c), dtype=torch.int32, device=dev),
                        torch.zeros((Tc, G.shape[1]), device=dev), live_c)
        bound_c = (cres.alpha <= 0) | (cres.alpha >= ctasks.c)
        cv1 = smo_state(G, ctasks, cres.alpha.clone(),
                        torch.where(bound_c, 5, 0).to(torch.int32), cres.w.clone(), live_c)
        t135_ms = cuda_ms(lambda: smo_epoch_kernel(**work, full_pass=True, shrink_k=5), 5,
                          reset(cv0))
        t135_cheap = cuda_ms(lambda: smo_epoch_kernel(**work, full_pass=False, shrink_k=5), 5,
                             reset(cv1))
        free_c = (~bound_c & real_c).sum(1)
        # blocks an SM by ptxas's registers and the launch's dynamic shared
        # memory (w and the row ring in registers at B' <= 2048: D stages of
        # B' floats, smo.cu's launch), each block 256 threads
        # (the SM's limits as the device reports them; the H100's data-sheet
        # figures where this PyTorch does not report one)
        props = torch.cuda.get_device_properties(dev)
        sm = {k: getattr(props, k, v) for k, v in (
            ("regs_per_multiprocessor", 65536), ("shared_memory_per_multiprocessor", 233472),
            ("max_threads_per_multi_processor", 2048))}
        cols = 1 if Bp <= 256 else 2 if Bp <= 512 else 4 if Bp <= 1024 else 8
        regs = b2_build[(ring_stages(Bp), cols)]["registers"]
        by_regs = sm["regs_per_multiprocessor"] // (-(-regs * 32 // 256) * 256 * 8)
        smem = 4 * Bp * ring_stages(Bp)
        by_smem = sm["shared_memory_per_multiprocessor"] // (smem + 1024)
        per_sm = min(by_regs, by_smem, sm["max_threads_per_multi_processor"] // 256)
        waves = -(-Tc // (props.multi_processor_count * per_sm))
        print(f"SM limits: {sm}; reported by the device: "
              f"{[k for k in sm if hasattr(props, k)]}")
        print(f"B2 at T={Tc} x {n_pad_c} (real rows up to {int(rows_t.max())}), B'={Bp}: full "
              f"epoch from 0 {t135_ms:.3f} ms ({t135_ms * 1e6 / int(rows_t.max()):.1f} ns per "
              f"real row of the largest task), cheap epoch from the cell {t135_cheap:.3f} ms "
              f"({int(free_c.max())} free rows in the largest task); at T={T45} x {n_pad45}: "
              f"{s_ms:.3f} / {cheap_ms:.3f} ms; {per_sm} blocks an SM ({regs} registers: "
              f"{by_regs}, {smem} B of shared memory: {by_smem}) on "
              f"{props.multi_processor_count} SMs: {waves} wave(s) at T={Tc}, "
              f"{-(-T45 // (props.multi_processor_count * per_sm))} at T={T45}")
        del cv0, cv1
        work.clear()
        # at a reduced size the port's CPU solve of the same cell on the same
        # factor: each task's dual objective within rtol 5e-3.  6000 rows of
        # a 10-class problem of the main path's shape with its classes set
        # further apart (sep 0.1): cut to 6000 rows, the main path's own
        # data sit near chance at every C whose cell the CPU solves in
        # seconds (CV errors 0.89 and 0.81 at C 1/16 and 1/4)
        xr, yr = make_multiclass(6000, p=784, n_classes=10, sep=0.1, within=0.06, seed=1)
        _, labels_r = np.unique(yr, return_inverse=True)
        kp_r = KernelParams("rbf", gamma=median_gamma(xr))
        fac_r = compute_factor(xr, kp_r, 512, seed=0, device=dev)
        masks_r = cv.kfold_masks(len(xr), folds, 0)
        # each card-vs-CPU comparison (this cell, the grid, the farm) runs on
        # the first 3000 of these rows, where the CPU's side takes 2.5x less
        # (CV errors 0.84 and 0.69 at C 1/16 and 1/4)
        xcmp, ycmp = xr[:3000], yr[:3000]
        _, labels_c = np.unique(ycmp, return_inverse=True)
        fac_c = compute_factor(xcmp, kp_r, 512, seed=0, device=dev)
        masks_c = cv.kfold_masks(len(xcmp), folds, 0)
        duals = {}
        for d in ("cuda", "cpu"):
            f = fac_c.G if d == "cuda" else fac_c.G.cpu()
            t_r, _ = cv.build_cv_tasks(labels_c, 10, 1 / 16, masks_c, device=d)
            smo_epoch_kernel.launches = 0
            t0 = time.perf_counter()
            r = dual_solver.solve_batch(f, t_r, gcfg)
            duals[d] = (r.dual_obj.cpu().numpy(), int(r.epochs.max()),
                        time.perf_counter() - t0, smo_epoch_kernel.launches,
                        bool((r.violation < gcfg.tol).all()))
        rel = float(np.max(np.abs(duals["cuda"][0] - duals["cpu"][0])
                           / np.abs(duals["cpu"][0])))
        print(f"cell at {len(xcmp)} x 784, B 512, C 1/16 ({t_r.n_tasks} tasks x "
              f"{t_r.idx.shape[1]}): "
              f"dual objective max rel diff card vs cpu {rel:.3e} (max 5e-3); epochs max "
              f"card {duals['cuda'][1]} cpu {duals['cpu'][1]}; card {duals['cuda'][2]:.3f} s "
              f"({duals['cuda'][3]} B2 launches), cpu {duals['cpu'][2]:.3f} s")
        check(rel <= 5e-3, "the card's cell disagrees with the CPU's")
        check(duals["cuda"][3] == duals["cuda"][1] and duals["cpu"][3] == 0,
              "B2 launches differ from the card's epochs, or the CPU launched B2")
        check(duals["cuda"][4] and duals["cpu"][4], "a reduced cell's task ends above tol")

    Cs_r = [1 / 16, 1 / 4]
    with phase("grid search, card vs cpu"):
        # the same grid at the comparisons' size on the card and on the CPU:
        # the same seed draws the same landmark rows
        kw_r = dict(budget=512, folds=folds, config=gcfg, seed=0)
        grid_r = {}
        for d in ("cuda", "cpu"):
            smo_epoch_kernel.launches = 0
            grid_r[d] = cv.grid_search(xcmp, ycmp, [kp_r.gamma], Cs_r, device=d, **kw_r)
            grid_r[d] = (grid_r[d], smo_epoch_kernel.launches)
        (gc, lc), (gp, lp) = grid_r["cuda"], grid_r["cpu"]
        diff_r = float(np.abs(gc.errors - gp.errors).max())
        print(f"reduced grid at {len(xcmp)} rows, gamma {kp_r.gamma:.6e} x C {Cs_r}: CV "
              f"errors card "
              f"{gc.errors[0].tolist()} cpu {gp.errors[0].tolist()} (max diff {diff_r:.4f}, "
              f"max 0.01); best card C {gc.best_C:g} cpu C {gp.best_C:g}; stage 2 card "
              f"{gc.stage2_seconds:.3f} s ({lc} B2 launches), cpu {gp.stage2_seconds:.3f} s")
        check(diff_r <= 0.01, "the card's CV errors disagree with the CPU's")
        check((gc.best_gamma, gc.best_C) == (gp.best_gamma, gp.best_C),
              "the card and the CPU select different cells")
        check(lc == sum(int(c.epochs.max()) for c in gc.cells) > 0 and lp == 0,
              "B2 launches differ from the card's cells, or the CPU launched B2")

    with phase("grid search, polished"):
        # against the unpolished grid on the card at the reduced size
        gc = cv.grid_search(xr, yr, [kp_r.gamma], Cs_r, **kw_r)
        smo_epoch_kernel.launches = 0
        pol_r = cv.grid_search(xr, yr, [kp_r.gamma], Cs_r, polish=True, **kw_r)
        diff_p = float(np.abs(pol_r.errors - gc.errors).max())
        for cp, cu in zip(pol_r.cells, gc.cells):
            print(f"cell C {cp.C:g}: polished CV error {cp.error:.4f}, stage 2 "
                  f"{cp.seconds:.4f} s; unpolished {cu.error:.4f}, {cu.seconds:.4f} s")
        print(f"polished grid: best C {pol_r.best_C:g} (unpolished {gc.best_C:g}), errors "
              f"max diff {diff_p:.4f} (max 0.03), {smo_epoch_kernel.launches} B2 launches")
        check((pol_r.best_gamma, pol_r.best_C) == (gc.best_gamma, gc.best_C),
              "the polished grid selects another cell")
        check(diff_p <= 0.03 and smo_epoch_kernel.launches > 0,
              "the polished grid's errors stray, or B2 never ran")

    farm_launches = {}
    with phase("grid task farm, ladder and concurrent"):
        # the reduced grid's cells on the grid task farm: T = 270, the
        # reduced factor's G (6000 x 512) from pinned host memory
        G_rh = host_buffer(tuple(fac_r.G.shape), torch.float32, dev).copy_(fac_r.G)
        f_scfg = StreamConfig(device_budget_bytes=256 << 20, prefetch=2,
                              autotune_prefetch=False)
        twice = lambda c: dataclasses.replace(c, max_epochs=c.max_epochs * 2 + 2)

        def farm_solve(G_f, cfg_f, ladder, device=dev, labels=labels_r, masks=masks_r):
            t_f, _, ch = cv.build_cv_grid_tasks(labels, 10, Cs_r, masks,
                                                ladder=ladder, device=device)
            smo_epoch_kernel.launches = 0
            t0 = time.perf_counter()
            r_f, s_f = solve_batch_streamed(G_f, t_f, cfg_f, stream_config=f_scfg,
                                            chain_next=ch, return_stats=True)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            return r_f, s_f, smo_epoch_kernel.launches, time.perf_counter() - t0

        def cells_equal(r_f, solos):
            FPr = r_f.alpha.shape[0] // len(solos)
            sl = [slice(ci * FPr, (ci + 1) * FPr) for ci in range(len(solos))]
            return (all(torch.equal(r_f.alpha[k], r.alpha) for k, r in zip(sl, solos)),
                    all(torch.equal(r_f.epochs[k], r.epochs) for k, r in zip(sl, solos)))

        # the ladder with every epoch a full pass: the serial streamed C loop,
        # each cell warm-started from the one before it
        p1 = dataclasses.replace(gcfg, full_pass_period=1)
        warm, serial_c = None, []
        for C in Cs_r:
            t_c, _ = cv.build_cv_tasks(labels_r, 10, C, masks_r, warm=warm, device=dev)
            serial_c.append(solve_batch_streamed(G_rh, t_c, p1, stream_config=f_scfg))
            warm = serial_c[-1].alpha
        lad, lad_st, lad_l, lad_s = farm_solve(G_rh, twice(p1), True)
        same_a, same_e = cells_equal(lad, serial_c)
        print(f"ladder at period 1, T {lad.alpha.shape[0]}: per-cell alphas equal to the "
              f"serial C loop's {same_a}, epochs equal {same_e}; epochs max "
              f"{[int(r.epochs.max()) for r in serial_c]}; farm {lad_st.epochs} epochs, "
              f"{lad_st.full_passes} full passes, {lad_l} B2 launches, tile "
              f"{lad_st.tile_rows}, {lad_s:.3f} s")
        check(same_a and same_e, "the ladder's cells differ from the serial C loop's")
        check(lad_l == lad_st.kernel_calls > 0, "B2 launches differ from the farm's blocks")
        # concurrent: no ladder, the default schedule, each cell from zero
        cold_c = [solve_batch_streamed(G_rh, cv.build_cv_tasks(labels_r, 10, C, masks_r,
                                                              device=dev)[0], gcfg,
                                       stream_config=f_scfg, return_stats=True)
                  for C in Cs_r]
        con, con_st, con_l, con_s = farm_solve(G_rh, gcfg, False)
        same_a, same_e = cells_equal(con, [r for r, _ in cold_c])
        most = max(st_c.bytes_g for _, st_c in cold_c)
        print(f"concurrent: cells equal to their cold solo solves: alphas {same_a}, epochs "
              f"{same_e}; G bytes {con_st.bytes_g} against the largest cell's {most} "
              f"({con_st.bytes_g / most:.3f}x, max 1.3) and the cells' sum "
              f"{sum(st_c.bytes_g for _, st_c in cold_c)}; {con_l} B2 launches, "
              f"{con_s:.3f} s")
        check(same_a and same_e, "a concurrent cell differs from its cold solo solve")
        check(con_st.bytes_g <= 1.3 * most, "the concurrent grid streamed over 1.3x a cell")
        # the farm (ladder, default schedule) on the card against the CPU, at
        # the comparisons' size
        val_r = cv._fold_val_sets(fac_c, labels_c, masks_c)
        G_ch = host_buffer(tuple(fac_c.G.shape), torch.float32, dev).copy_(fac_c.G)
        farm_r = {}
        for d in ("cuda", "cpu"):
            r_d, s_d, l_d, secs = farm_solve(G_ch if d == "cuda" else fac_c.G.cpu(),
                                             twice(gcfg), True, device=d, labels=labels_c,
                                             masks=masks_c)
            FPr = r_d.alpha.shape[0] // len(Cs_r)
            errs = [cv._cv_error_from(val_r, 10, r_d.w[ci * FPr:(ci + 1) * FPr])
                    for ci in range(len(Cs_r))]
            farm_r[d] = (r_d.dual_obj.cpu().numpy(), errs, l_d, secs, s_d)
        rel_f = float(np.max(np.abs(farm_r["cuda"][0] - farm_r["cpu"][0])
                             / np.abs(farm_r["cpu"][0])))
        print(f"farm card vs cpu at {len(xcmp)} rows: dual objective max rel diff "
              f"{rel_f:.3e} (max 5e-3); CV "
              f"errors card {farm_r['cuda'][1]} cpu {farm_r['cpu'][1]}; card "
              f"{farm_r['cuda'][3]:.3f} s ({farm_r['cuda'][2]} B2 launches, "
              f"{farm_r['cuda'][4].epochs} epochs), cpu {farm_r['cpu'][3]:.3f} s "
              f"({farm_r['cpu'][4].epochs} epochs)")
        check(rel_f <= 5e-3, "the card's farm disagrees with the CPU's")
        check(int(np.argmin(farm_r["cuda"][1])) == int(np.argmin(farm_r["cpu"][1])),
              "the card's farm and the CPU's select different cells")
        check(farm_r["cuda"][2] == farm_r["cuda"][4].kernel_calls > 0
              and farm_r["cpu"][2] == 0, "B2 launches differ from the card farm's "
              "blocks, or the CPU launched B2")
        farm_launches["reduced"] = lad_l + con_l + farm_r["cuda"][2]
        del fac_r, fac_c, G_rh, G_ch, lad, con, cold_c, serial_c, val_r

    with phase("grid search, streamed serial"):
        Cs_s = Cs_main[:2]                 # the main grid's first two cells at gamma g
        s_cfg = StreamConfig(device_budget_bytes=256 << 20, prefetch=2,
                             autotune_prefetch=False)
        # same factor: the main path's, its G in pinned host memory; each
        # cell streams, bit-equal to solve_batch, so the errors are equal
        G_h = host_buffer(tuple(G.shape), torch.float32, dev).copy_(G)
        fac_h = dataclasses.replace(fac, G=G_h, streamed=True)
        for C in Cs_s:
            kw_c = dict(budget=budget, folds=folds, config=gcfg, seed=0)
            t0 = time.perf_counter()
            e_card, _ = cv.cross_validate(xtr, ytr, kp, C, factor=fac, **kw_c)
            t_card = time.perf_counter() - t0
            smo_epoch_kernel.launches = 0
            t0 = time.perf_counter()
            e_host, _ = cv.cross_validate(xtr, ytr, kp, C, factor=fac_h,
                                          stream_config=s_cfg, **kw_c)
            t_host = time.perf_counter() - t0
            print(f"cross_validate C {C:g} on the main path's factor: card G {e_card:.4f} "
                  f"({t_card:.3f} s), pinned host G streamed {e_host:.4f} ({t_host:.3f} s, "
                  f"{smo_epoch_kernel.launches} B2 launches)")
            check(e_host == e_card, "the streamed cross_validate differs from the card's")
            check(smo_epoch_kernel.launches > 0, "the streamed cell never launched B2")
        del G_h, fac_h
        # routed factor: an f32 stage 1 that streams, so every cell streams
        s_grid, s_counts, sg_launches, s_wall = counted_grid(
            xtr, ytr, [gamma], Cs_s, budget=budget, folds=folds, config=gcfg, seed=0,
            stream_config=s_cfg, farm=False)
        grid_cells(s_grid, s_counts)
        diff_s = float(np.abs(s_grid.errors[0] - grid.errors[g_i, :2]).max())
        print(f"streamed serial grid: stage 1 {s_grid.stage1_seconds:.3f} s, stage 2 "
              f"{s_grid.stage2_seconds:.3f} s, wall {s_wall:.3f} s, launches {sg_launches}; "
              f"CV errors {s_grid.errors[0].tolist()} vs the monolithic grid's "
              f"{grid.errors[g_i, :2].tolist()} (max diff {diff_s:.4f}, max 0.01)")
        check(all(c.stream_stats is not None for c in s_grid.cells), "a cell did not stream")
        check(all(n == c.stream_stats.kernel_calls > 0 for (n, _), c in
                  zip(s_counts, s_grid.cells)), "a streamed cell's B2 launches differ "
              "from its blocks")
        check(diff_s <= 0.01, "the streamed grid's CV errors stray from the monolithic grid's")
        init_s = [c.stream_stats.init_seconds for c in s_grid.cells]
        print(f"the warm cell's init pass (its fp64 w0 sums, one product shape a "
              f"block): {init_s[1]:.4f} s")
        # the same grid with farm=None: the grid task farm, every (C, fold,
        # pair) cell of gamma g in one streamed TaskBatch; its stage 2 alone
        # measured for its peak device memory (the byte model leaves out the
        # task state, as in the streamed path phase: 13 words a task
        # position, one a row of G for q, and B2's scratch)
        farm_peak = {}
        solve_auto = cv.solve_streamed_auto

        def peaked(G_f, tasks_f, *a, **k):
            base_f = peak_start()
            out = solve_auto(G_f, tasks_f, *a, **k)
            farm_peak.update(peak=peak_since(base_f), T=tasks_f.n_tasks,
                             n_pad=int(tasks_f.idx.shape[1]), n=int(G_f.shape[0]))
            return out

        cv.solve_streamed_auto = peaked
        try:
            f_grid, _, f_launches, f_wall = counted_grid(
                xtr, ytr, [gamma], Cs_s, budget=budget, folds=folds, config=gcfg, seed=0,
                stream_config=s_cfg)
        finally:
            cv.solve_streamed_auto = solve_auto
        grid_cells(f_grid)
        fst = f_grid.stream_stats[0] if f_grid.stream_stats else None
        check(fst is not None and f_launches["smo_epoch"] == fst.kernel_calls > 0,
              "farm=None did not run the farm, or its B2 launches differ from its blocks")
        ser = [c.stream_stats for c in s_grid.cells]
        allow_f = 4 * (13 * farm_peak["T"] * farm_peak["n_pad"] + farm_peak["n"]) \
            + fst.scratch_bytes
        limit_f = s_cfg.device_budget_bytes + allow_f
        diff_f = float(np.abs(f_grid.errors[0] - s_grid.errors[0]).max())
        lead = np.sort(s_grid.errors[0])
        print(f"grid task farm, T {farm_peak['T']} x {farm_peak['n_pad']}: {fst.epochs} "
              f"epochs ({fst.full_passes} full passes), bytes_g {fst.bytes_g}, "
              f"{fst.kernel_calls} B2 launches, stage 2 {f_grid.stage2_seconds:.3f} s, "
              f"wall {f_wall:.3f} s, tile {fst.tile_rows}, B2 scratch {fst.scratch_bytes} B, "
              f"drain {fst.drain_seconds:.3f} s, compaction {fst.compact_seconds:.3f} s, "
              f"h2d {fst.h2d_gbps:.2f} GB/s; epochs max by C "
              f"{[int(c.epochs.max()) for c in f_grid.cells]}")
        print(f"serial streamed grid's sums: {sum(st_c.epochs for st_c in ser)} epochs, "
              f"bytes_g {sum(st_c.bytes_g for st_c in ser)}, "
              f"{sum(st_c.kernel_calls for st_c in ser)} B2 launches, stage 2 "
              f"{s_grid.stage2_seconds:.3f} s; farm / serial: bytes_g "
              f"{fst.bytes_g / sum(st_c.bytes_g for st_c in ser):.3f}, stage 2 "
              f"{f_grid.stage2_seconds / s_grid.stage2_seconds:.3f}")
        print(f"farm CV errors {f_grid.errors[0].tolist()} vs the serial streamed grid's "
              f"{s_grid.errors[0].tolist()} (max diff {diff_f:.4f}, max 0.01); best C farm "
              f"{f_grid.best_C:g} serial {s_grid.best_C:g} (serial lead "
              f"{lead[1] - lead[0]:.4f})")
        print(f"farm stage 2 peak device memory {farm_peak['peak']} B: budget "
              f"{s_cfg.device_budget_bytes} + task-state allowance {allow_f} = {limit_f}")
        check(farm_peak["T"] == 2 * 135, "the farm's batch is not 2 Cs x 3 folds x 45 pairs")
        check(diff_f <= 0.01, "the farm's CV errors stray from the serial streamed grid's")
        check(lead[1] - lead[0] <= 0.01 or f_grid.best_C == s_grid.best_C,
              "the farm selects another cell than the serial streamed grid")
        check(farm_peak["peak"] <= limit_f,
              "the farm's peak device memory above the budget plus the allowance")
        # the concurrent farm (warm_start=False: no chain, every cell from
        # zero) beside the cold serial streamed grid: each farmed cell is the
        # cold cell's solve, so the errors are equal; the G bytes of the
        # whole grid against the largest cell's and the cells' sum
        c_grid, _, _, c_wall = counted_grid(
            xtr, ytr, [gamma], Cs_s, budget=budget, folds=folds, config=gcfg, seed=0,
            stream_config=s_cfg, farm=False, warm_start=False)
        cf_grid, _, cf_launches, cf_wall = counted_grid(
            xtr, ytr, [gamma], Cs_s, budget=budget, folds=folds, config=gcfg, seed=0,
            stream_config=s_cfg, warm_start=False)
        cser = [c.stream_stats for c in c_grid.cells]
        cfs = cf_grid.stream_stats[0] if cf_grid.stream_stats else None
        check(cfs is not None and cf_launches["smo_epoch"] == cfs.kernel_calls > 0,
              "the concurrent farm did not run, or its B2 launches differ from its blocks")
        big = max(st_c.bytes_g for st_c in cser)
        print(f"concurrent farm: {cfs.epochs} epochs ({cfs.full_passes} full passes), bytes_g "
              f"{cfs.bytes_g} against the largest cold cell's {big} "
              f"({cfs.bytes_g / big:.3f}x) and the cold cells' sum "
              f"{sum(st_c.bytes_g for st_c in cser)} "
              f"({cfs.bytes_g / sum(st_c.bytes_g for st_c in cser):.3f}x); {cfs.kernel_calls} "
              f"B2 launches against {sum(st_c.kernel_calls for st_c in cser)}; stage 2 "
              f"{cf_grid.stage2_seconds:.3f} s against {c_grid.stage2_seconds:.3f} s, "
              f"compaction {cfs.compact_seconds:.3f} s against "
              f"{sum(st_c.compact_seconds for st_c in cser):.3f} s; epochs max by C farm "
              f"{[int(c.epochs.max()) for c in cf_grid.cells]} cold "
              f"{[int(c.epochs.max()) for c in c_grid.cells]}; CV errors farm "
              f"{cf_grid.errors[0].tolist()} cold {c_grid.errors[0].tolist()}")
        # the farm's budget is the grid's (max_epochs x |Cs| + |Cs|): a cold
        # cell that stops at max_epochs runs on in the farm, by design
        if max(int(c.epochs.max()) for c in c_grid.cells) < gcfg.max_epochs:
            check(np.array_equal(cf_grid.errors, c_grid.errors)
                  and all(np.array_equal(f.epochs, c.epochs)
                          for f, c in zip(cf_grid.cells, c_grid.cells)),
                  "a concurrent farm cell differs from its cold serial cell")
        else:
            print("a cold serial cell stopped at max_epochs: cells not compared")
        farm_launches["full width"] = fst.kernel_calls + cfs.kernel_calls

    with phase("driver --grid"):
        # the paper's driver through its CLI with the grid flags; the gamma
        # grid around the median gamma of the features it extracts (the
        # reduced backbone from seed 0, as the CLI builds it)
        cfg_r = get_config("qwen3-0.6b", reduced=True)
        toks_r, _ = class_conditioned_tokens(400, 3, 16, cfg_r.vocab_size)
        m_r = init_model(torch.Generator(device=dev).manual_seed(0), cfg_r, device=dev)
        g_r = median_gamma(extract_features(cfg_r, m_r, toks_r))
        del m_r
        argv = ["--classes", "3", "--n", "400", "--seq", "16", "--budget", "64",
                "--grid-cs", "1,4", "--grid-gammas", f"{g_r / 2:.6g},{g_r:.6g}",
                "--grid-folds", "3"]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        run_g = subprocess.run([sys.executable, "-m", "repro_torch.launch.train_svm", *argv],
                               cwd=ROOT, env=env, capture_output=True, text=True,
                               timeout=600)
        out = run_g.stdout
        print(out.strip())
        print(f"train_svm {' '.join(argv)}: exit code {run_g.returncode}, "
              f"{time.perf_counter() - t0:.3f} s")
        found = re.search(r"test error: ([0-9.]+) \(chance ([0-9.]+)\)", out)
        gamma_lines = [l for l in out.splitlines() if l.startswith("  gamma ")]
        check(run_g.returncode == 0, f"the driver failed:\n{run_g.stderr[-4000:]}")
        check("grid: 2 gammas x 2 Cs, 36 binary SVMs" in out and len(gamma_lines) == 2
              and "grid best: " in out, "the driver printed no grid lines")
        check(found is not None and float(found.group(1)) < float(found.group(2)),
              "the driver's refit does not beat chance")
        # the same flags with --stream: the grid task farm, a farm line a
        # gamma (in this process, whose kernels are built and loaded)
        out_s = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out_s):
            try:
                test_err = driver.main(argv + ["--stream"])
                code = 0
            except SystemExit as e:
                code = e.code
        out = out_s.getvalue()
        print(out.strip())
        print(f"train_svm {' '.join(argv)} --stream: exit code {code}, "
              f"{time.perf_counter() - t0:.3f} s")
        farm_lines = [l for l in out.splitlines() if l.startswith("  gamma ") and "  farm: " in l]
        found = re.search(r"test error: ([0-9.]+) \(chance ([0-9.]+)\)", out)
        check(code == 0 and len(farm_lines) == 2,
              "--grid-cs with --stream did not run the farm for each gamma")
        check(found is not None and float(found.group(1)) < float(found.group(2)),
              "the streamed driver's refit does not beat chance")

    with phase("solve_compact"):
        # the main path's largest OVO task: its rows of the main path's
        # factor gathered on the card, through the bucket-compaction solver
        real_m = svm.tasks_.c > 0
        t_big = int(real_m.sum(1).argmax())
        keep = real_m[t_big]
        rows_m = svm.tasks_.idx[t_big][keep].long()
        G_rows = G[rows_m]
        y_t, c_t = svm.tasks_.y[t_big][keep], svm.tasks_.c[t_big][keep]
        smo_epoch_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a_c, w_c, st_c = solve_compact(G_rows, y_t, c_t, gcfg)
        torch.cuda.synchronize()
        c_secs = time.perf_counter() - t0
        c_launches = smo_epoch_kernel.launches
        one = dual_solver.TaskBatch(svm.tasks_.idx[t_big:t_big + 1],
                                    svm.tasks_.y[t_big:t_big + 1],
                                    svm.tasks_.c[t_big:t_big + 1],
                                    torch.zeros_like(svm.tasks_.c[t_big:t_big + 1]))
        r_one = dual_solver.solve_batch(G, one, gcfg)
        d_c = float(a_c.double().sum() - 0.5 * torch.dot(w_c.double(), w_c.double()))
        d_b = float(r_one.dual_obj[0])
        rel_c = abs(d_c - d_b) / abs(d_b)
        t0 = time.perf_counter()
        _, _, st_off = solve_compact(G_rows, y_t, c_t,
                                     dataclasses.replace(gcfg, shrink=False))
        torch.cuda.synchronize()
        off_secs = time.perf_counter() - t0
        buckets = sorted(set(st_c.active_history))
        print(f"task {t_big}: {len(rows_m)} rows x {G.shape[1]}; solve_compact {st_c.epochs} "
              f"epochs ({st_c.full_passes} full), {c_launches} B2 launches, {c_secs:.3f} s, "
              f"final violation {st_c.final_violation:.4g}, rows swept {st_c.rows_streamed}, "
              f"buckets {buckets}; dual objective {d_c:.6f} against solve_batch's "
              f"{d_b:.6f} ({int(r_one.epochs[0])} epochs): rel diff {rel_c:.3e} (max 1e-3); "
              f"without shrinking {st_off.epochs} epochs, rows swept "
              f"{st_off.rows_streamed}, {off_secs:.3f} s")
        check(c_launches == st_c.epochs > 0 and a_c.is_cuda,
              "solve_compact did not launch B2 once an epoch on the card")
        check(rel_c <= 1e-3 and st_c.final_violation < gcfg.tol,
              "solve_compact disagrees with solve_batch or ends above tol")
        check(st_c.rows_streamed < st_off.rows_streamed,
              "shrinking did not sweep fewer rows than no shrinking")
        del G_rows, a_c, w_c, r_one

    # ------------------------------------------------------- the LIBSVM route
    libsvm_dir = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    lib_launches = {"flash_attention": 0, "gram": 0, "gram_q8": 0, "smo_epoch": 0}

    def reset_counts():
        for fn in (flash_attention_kernel, gram_kernel, gram_q8_kernel, smo_epoch_kernel):
            fn.launches = 0

    def read_counts(add: bool = True) -> dict:
        got = {"flash_attention": flash_attention_kernel.launches,
               "gram": gram_kernel.launches, "gram_q8": gram_q8_kernel.launches,
               "smo_epoch": smo_epoch_kernel.launches}
        if add:
            for k, v in got.items():
                lib_launches[k] += v
        return got

    def run_driver(argv):
        """launch/train_svm.py's main in this process (its kernels built and
        loaded): its stdout, its return value and train_from_libsvm's result."""
        seen, real = {}, driver.train_from_libsvm

        def keep(*a, **kw):
            seen["res"] = real(*a, **kw)
            return seen["res"]

        out = io.StringIO()
        driver.train_from_libsvm = keep
        try:
            with contextlib.redirect_stdout(out):
                ret = driver.main(argv)
        finally:
            driver.train_from_libsvm = real
        return ret, seen["res"], out.getvalue()

    with phase("libsvm ingest, full width"):
        # the main path's rows, each keeping about 19% of its entries by a
        # seeded mask (LIBSVM's mnist has about 150 nonzeros of 784), written
        # as LIBSVM text and read back into CSR.  Each column keeps its
        # entries at a rate drawn from Beta(0.19, 0.81) (mean 0.19): as in
        # mnist, where border pixels are nearly always 0 and central ones
        # often set, the rows share most of their support (a mask drawn
        # alike for every entry leaves two rows 3.6% of common columns, and
        # the RBF kernel next to no class signal)
        col_rate = np.random.default_rng(1).beta(0.19, 0.81, size=p_tr)
        keep = np.random.default_rng(2).random((len(xtr) + len(xte), p_tr)) < col_rate
        xs_tr = np.where(keep[:len(xtr)], xtr, np.float32(0))
        xs_te = np.where(keep[len(xtr):], xte, np.float32(0))
        train_svm = os.path.join(libsvm_dir.name, "train.svm")
        test_svm = os.path.join(libsvm_dir.name, "test.svm")
        t0 = time.perf_counter()
        write_libsvm(train_svm, xs_tr, ytr)
        write_libsvm(test_svm, xs_te, yte)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        data = read_libsvm(train_svm, n_features=p_tr)
        t_read = time.perf_counter() - t0
        sizes = (os.path.getsize(train_svm), os.path.getsize(test_svm))
        rows_k, cols_k = np.nonzero(keep[:len(xtr)])
        same_idx = (np.array_equal(data.indptr, np.concatenate(
            [[0], np.cumsum(keep[:len(xtr)].sum(1))])) and np.array_equal(data.indices, cols_k))
        want_v = xtr[rows_k, cols_k]
        # %g keeps six significant digits: half a unit of the sixth, then
        # fp32's rounding of the parsed value
        v_share = float((np.abs(data.values - want_v) / (5.1e-6 * np.abs(want_v))).max())
        print(f"wrote {len(xtr)} + {len(xte)} rows ({sizes[0]} + {sizes[1]} bytes) in "
              f"{t_write:.3f} s; read {data.n} rows x {data.n_features}, nnz "
              f"{len(data.values)} ({len(data.values) / data.n:.1f} a row) in {t_read:.3f} s: "
              f"{data.n / t_read:.0f} rows/s, {sizes[0] / t_read / 1e6:.2f} MB/s")
        print(f"CSR indices equal to the mask {same_idx}; values against the rows: largest "
              f"share of %g's rounding {v_share:.3f} (max 1); labels equal "
              f"{np.array_equal(data.labels, ytr)}")
        check(same_idx and v_share <= 1.0 and np.array_equal(data.labels, ytr),
              "the CSR read back differs from the rows written")
        del rows_k, cols_k, want_v

    with phase("libsvm factor, CSR vs dense"):
        # the driver's --libsvm stage 1 (--device-budget-mb 256) on both
        # wires, against compute_factor_streamed on the densified rows with
        # the same landmark rows: bit for bit
        lm_rows = np.sort(np.random.default_rng(0).choice(data.n, 256, replace=False))
        kp_l = KernelParams("rbf", gamma=median_gamma(data.densify_rows(lm_rows)))
        t0 = time.perf_counter()
        dense_l = data.densify()
        t_dense = time.perf_counter() - t0
        print(f"gamma {kp_l.gamma:.6e}; the whole CSR densified on the host in "
              f"{t_dense:.3f} s")
        for wire in ("f32", "int8"):
            cfg_l = StreamConfig(device_budget_bytes=256 << 20, stage1_dtype=wire)
            runs = {}
            for route in ("csr", "dense"):
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f = (compute_factor_streamed_csr(data, kp_l, budget, config=cfg_l, device=dev)
                     if route == "csr" else
                     compute_factor_streamed(dense_l, kp_l, budget, config=cfg_l, device=dev))
                torch.cuda.synchronize()
                runs[route] = (f, time.perf_counter() - t0, read_counts(route == "csr"))
            (fc, tc, lc), (fd, td, _) = runs["csr"], runs["dense"]
            same = all(torch.equal(getattr(fc, k), getattr(fd, k))
                       for k in ("G", "landmarks", "projector", "eigvals"))
            s1c, s1d = fc.stage1_stats, fd.stage1_stats
            print(f"{wire} wire: CSR stage 1 {tc:.3f} s (densify {s1c.source_seconds:.3f} s, "
                  f"encode {s1c.encode_seconds:.3f}, put {s1c.put_seconds:.3f}, drain "
                  f"{s1c.drain_seconds:.3f}, pinned G {s1c.alloc_seconds:.3f}), dense stage 1 "
                  f"{td:.3f} s (slicing {s1d.source_seconds:.3f} s); {s1c.chunks} chunks, "
                  f"rank {fc.effective_rank}; G, landmarks, projector, eigvals bit-equal "
                  f"{same}; launches {lc}")
            want = ({"gram": 1 + s1c.chunks, "gram_q8": 0} if wire == "f32"
                    else {"gram": 1, "gram_q8": s1c.chunks})
            check(same, f"{wire} wire: the CSR factor differs from the dense streamed one")
            check({k: lc[k] for k in want} == want and s1c.chunks > 1,
                  f"{wire} wire: launches {lc}, not {want}")
            del fc, fd, runs, f
        del dense_l

    libsvm_wall = {}
    with phase("driver --libsvm, full width"):
        argv_l = ["--libsvm", train_svm, "--n-features", str(p_tr), "--budget", str(budget),
                  "--C", "1", "--device-budget-mb", "256"]
        t0 = time.perf_counter()
        data_te = read_libsvm(test_svm, n_features=p_tr)
        xs_te_read = data_te.densify()
        print(f"test file: {data_te.n} rows in {time.perf_counter() - t0:.3f} s")
        for extra in ([], ["--stage1-dtype", "int8"]):
            reset_counts()
            t0 = time.perf_counter()
            ret, res_l, out = run_driver(argv_l + extra)
            wall_l = time.perf_counter() - t0
            cnt = read_counts()
            print(out.strip())
            svm_l, st = res_l.svm, res_l.svm.stats
            wire = st.stage1_stats.wire_dtype
            libsvm_wall[wire] = wall_l
            lines = out.splitlines()
            print(f"train_svm {' '.join(argv_l[2:] + extra)}: {wall_l:.3f} s (read "
                  f"{res_l.read_seconds:.3f} s, stage 1 {st.stage1_seconds:.3f} s, stage 2 "
                  f"{st.stage2_seconds:.3f} s), returned {ret}; launches {cnt}")
            check(ret == res_l.train_error and lines[-1] == f"train error: {ret:.4f}"
                  and lines[0].startswith(f"libsvm: {len(xtr)} rows x {p_tr} features in ")
                  and any(l.startswith("stage1 stream: ") for l in lines)
                  and any(l.startswith("stage2 stream: ") for l in lines),
                  "the driver's --libsvm run did not print the reference's lines")
            check(st.stage1_streamed and st.stage2_streamed and st.n_tasks == 45,
                  "the --libsvm route did not stream both stages over 45 tasks")
            s1l, s2l = st.stage1_stats, st.stage2_stats
            want = ({"gram": 1 + s1l.chunks, "gram_q8": 0} if wire == "f32"
                    else {"gram": 1, "gram_q8": s1l.chunks})
            want.update(smo_epoch=s2l.kernel_calls, flash_attention=0)
            check(cnt == want and min(cnt[k] for k in want if want[k]) > 0,
                  f"--libsvm ({wire}): launches {cnt}, not {want}")
            # the training votes from G against predict on the dense rows
            # (features through B1), and the test file's rows
            t0 = time.perf_counter()
            pred_g = svm_l.predict_from_factor()
            t_pf = time.perf_counter() - t0
            reset_counts()
            t0 = time.perf_counter()
            pred_x = svm_l.predict(xs_tr)
            t_px = time.perf_counter() - t0
            pred_te = svm_l.predict(xs_te_read)
            read_counts()
            agree_l = float(np.mean(pred_g == pred_x))
            # f32 wire: G is K(x, landmarks) @ projector through B1 as the
            # features are, so at most a near tie may flip; int8 wire: G is
            # K of the codec's rows, which moves G by up to 0.05, and the
            # streamed path's bound against the f32 fit (0.99) holds
            min_agree = 0.999 if wire == "f32" else 0.99
            err_te = float(np.mean(pred_te != yte))
            print(f"{wire}: predict_from_factor (host G {tuple(svm_l.factor.G.shape)}, fp64) "
                  f"{t_pf:.3f} s against predict on the dense training rows {t_px:.3f} s: "
                  f"agreement {agree_l:.5f} (min {min_agree}); train error {res_l.train_error:.4f}, "
                  f"test error {err_te:.4f} (chance 0.90); stage 2 {s2l.epochs} epochs, "
                  f"{s2l.kernel_calls} B2 launches, {s2l.bytes_g} G bytes")
            check(agree_l >= min_agree,
                  f"--libsvm ({wire}): votes from G agree {agree_l} < {min_agree}")
            check(err_te < 0.9 and res_l.train_error < 0.9,
                  f"--libsvm ({wire}): errors not below chance")
            del res_l, svm_l
        del xs_te_read

    with phase("libsvm bad rows"):
        # 6000 rows, then three bad lines: a non-finite value, a 0-based
        # index and a malformed token
        small = os.path.join(libsvm_dir.name, "small.svm")
        bad = os.path.join(libsvm_dir.name, "bad.svm")
        write_libsvm(small, xs_tr[:6000], ytr[:6000])
        with open(small) as f_in, open(bad, "w") as f_out:
            f_out.write(f_in.read())
            f_out.write("1 3:nan 4:0.5\n2 0:1.5\n0 1:0.25 5-0.5\n")
        argv_s = ["--n-features", str(p_tr), "--budget", "512", "--C", "1",
                  "--device-budget-mb", "256"]
        reset_counts()
        _, clean_r, _ = run_driver(["--libsvm", small] + argv_s)
        _, skip_r, out_s = run_driver(["--libsvm", bad, "--on-bad-row", "skip"] + argv_s)
        cnt = read_counts()
        same_s = (all(torch.equal(getattr(clean_r.svm.factor, k), getattr(skip_r.svm.factor, k))
                      for k in ("G", "landmarks", "projector", "eigvals"))
                  and skip_r.train_error == clean_r.train_error)
        try:
            run_driver(["--libsvm", bad] + argv_s)
            raised = "nothing"
        except BadRowError as e:
            raised = str(e)
        print(f"skip: {out_s.splitlines()[0]!r}; factor and train error "
              f"({skip_r.train_error:.4f}) bit-equal to the clean file's {same_s}; without "
              f"skip: BadRowError {raised!r}; launches {cnt}")
        check("libsvm: skipped 3 bad row(s) (--on-bad-row skip)" in out_s and same_s,
              "--on-bad-row skip did not drop exactly the bad rows")
        check(raised.startswith("line 6001: non-finite value"),
              "without --on-bad-row skip the first bad line was not named")
        del clean_r, skip_r

    with phase("save / load"):
        # the main path's monolithic fit and the streamed path's fit, saved
        # and loaded onto the card: bit-equal decision values on the test rows
        reset_counts()
        for name, fitted in (("monolithic", svm), ("streamed", svm_s)):
            d = os.path.join(libsvm_dir.name, name)
            t0 = time.perf_counter()
            path = fitted.save(d)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = LPDSVM.load(d)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            same_d = np.array_equal(back.decision_function(xte), fitted.decision_function(xte))
            try:
                back.predict_from_factor()
                raised = False
            except RuntimeError:
                raised = True
            print(f"{name}: {os.path.getsize(path)} bytes ({os.path.basename(path)}), save "
                  f"{t_save:.3f} s, load {t_load:.3f} s onto {back.device}; decision values "
                  f"on {len(xte)} test rows bit-equal {same_d}; predict_from_factor raises "
                  f"{raised}")
            check(same_d and back.W_.is_cuda, f"{name}: the loaded model decides otherwise")
            check(raised, f"{name}: predict_from_factor ran on a loaded model")
            del back
        print(f"launches {read_counts()}")

    with phase("predict_from_factor, card G vs host G"):
        G_card = svm.factor.G
        G_pin = host_buffer(tuple(G_card.shape), torch.float32, dev).copy_(G_card)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v_card = svm.predict_from_factor()
        t_card = time.perf_counter() - t0
        svm.factor.G = G_pin
        try:
            t0 = time.perf_counter()
            v_host = svm.predict_from_factor()
            t_host = time.perf_counter() - t0
        finally:
            svm.factor.G = G_card
        print(f"the main path's factor ({tuple(G_card.shape)}, 45 tasks): votes from the "
              f"card G in {t_card:.3f} s, from a pinned host copy in {t_host:.3f} s; "
              f"identical {np.array_equal(v_card, v_host)}; train error "
              f"{float(np.mean(v_card != ytr)):.4f}")
        check(np.array_equal(v_card, v_host), "a card G and a host G vote differently")
        del G_pin
    # ------------------------------------------------------- the disk tier
    shard_launches = {"flash_attention": 0, "gram": 0, "gram_q8": 0, "smo_epoch": 0}
    n_main = len(xtr)                    # the main path's rows (n_tr is the driver's now)

    def add_shard_launches() -> dict:
        got = read_counts(add=False)
        for k, v in got.items():
            shard_launches[k] += v
        return got

    with phase("shard store, ingest and reuse"):
        # the driver's --libsvm run with --shard-dir: the first run parses the
        # text into f32 shards, the second reuses them and parses nothing
        # (every parse function raises while it runs)
        import repro_torch.data.libsvm_format as lf_mod
        from repro_torch.core.shards import (ShardStore, ShardWriter,
                                             attach_source_rebuilder)
        from repro_torch.core.streaming import (compute_factor_streamed_shards,
                                                stream_factor_blocks)
        shard_root = os.path.join(libsvm_dir.name, "shards")
        argv_sh = argv_l + ["--shard-dir", shard_root]
        reset_counts()
        t0 = time.perf_counter()
        ret_i, res_i, out_i = run_driver(argv_sh)
        wall_i = time.perf_counter() - t0
        cnt_i = add_shard_launches()
        print(out_i.strip())
        parse_names = ("read_libsvm", "read_libsvm_blocks", "count_libsvm_rows")
        saved = {k: getattr(lf_mod, k) for k in parse_names}
        saved_driver = driver.read_libsvm

        def no_parse(*a, **kw):
            raise AssertionError("the reused store parsed the text")

        for k in parse_names:
            setattr(lf_mod, k, no_parse)
        driver.read_libsvm = no_parse
        try:
            reset_counts()
            t0 = time.perf_counter()
            ret_r, res_r, out_r = run_driver(argv_sh)
            wall_r = time.perf_counter() - t0
        finally:
            for k, fn in saved.items():
                setattr(lf_mod, k, fn)
            driver.read_libsvm = saved_driver
        cnt_r = add_shard_launches()
        print(out_r.strip())
        si, sr = res_i.shard_stats, res_r.shard_stats
        store_f = res_r.store
        same_f = all(torch.equal(getattr(res_i.svm.factor, k), getattr(res_r.svm.factor, k))
                     for k in ("G", "landmarks", "projector", "eigvals"))
        print(f"ingest: parse and write {res_i.read_seconds:.3f} s, {si.shards_written} "
              f"shards, {si.bytes_written} B written in {si.write_seconds:.3f} s (atomic, "
              f"fsynced); reuse: open {res_r.read_seconds:.3f} s")
        print(f"driver walls: ingesting run {wall_i:.3f} s, reusing run {wall_r:.3f} s, "
              f"--libsvm without a store {libsvm_wall['f32']:.3f} s; stage 1 "
              f"{res_i.svm.stats.stage1_seconds:.3f} / {res_r.svm.stats.stage1_seconds:.3f} s, "
              f"stage 2 {res_i.svm.stats.stage2_seconds:.3f} / "
              f"{res_r.svm.stats.stage2_seconds:.3f} s; launches {cnt_i} / {cnt_r}")
        print(f"reused run: {sr.shards_read} shard reads, {sr.bytes_read} B at "
              f"{sr.read_gbps:.2f} GB/s (reads {sr.read_seconds:.3f} s, checksums "
              f"{sr.verify_seconds:.3f} s, {sr.verifications} verified); train error "
              f"{ret_r:.4f} against {ret_i:.4f}; factor bit-equal {same_f}")
        check(res_i.ingested and not res_r.ingested
              and "— ingested (parsed once)" in out_i and "— reused (no parse)" in out_r
              and any(ln.startswith("shard io: ") for ln in out_r.splitlines()),
              "the driver's --shard-dir runs did not ingest once and then reuse")
        check(ret_r == ret_i and same_f,
              "the reused store's factor or training error differs from the ingesting run's")
        check(store_f.n_shards == -(-n_main // 4096) and store_f.n == n_main,
              "the store does not hold the file's rows in 4096-row shards")
        check(cnt_r["gram"] == 1 + res_r.svm.stats.stage1_stats.chunks
              and cnt_r["smo_epoch"] == res_r.svm.stats.stage2_stats.kernel_calls > 0,
              f"the reused run's launches {cnt_r} are not its chunks and blocks")

        # an int8 store, written with ShardWriter from the CSR already parsed,
        # on the int8 wire: its stored codes through B3 give the CSR route's
        # chunks of 4096 rows (host encoder, B3) the same G bit for bit, on
        # the store's landmarks and projector (an int8 store's landmarks are
        # its decoded rows, the CSR route's the parsed ones)
        dir8 = os.path.join(shard_root, "int8")
        t0 = time.perf_counter()
        w8 = ShardWriter(dir8, p_tr, shard_rows=4096, dtype="int8", with_labels=True)
        for blk, lab in data.iter_dense_blocks(4096):
            w8.append(blk, lab)
        w8.finish()
        t_w8 = time.perf_counter() - t0
        st8 = ShardStore(dir8)
        cfg8 = StreamConfig(device_budget_bytes=256 << 20, stage1_dtype="int8")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f8 = compute_factor_streamed_shards(st8, kp_l, budget, config=cfg8, device=dev)
        torch.cuda.synchronize()
        t_f8 = time.perf_counter() - t0
        cnt8 = add_shard_launches()
        reset_counts()
        t0 = time.perf_counter()
        host8 = stream_factor_blocks((blk for blk, _ in data.iter_dense_blocks(4096)),
                                     data.n, f8.landmarks, f8.projector, kp_l,
                                     wire_dtype="int8")
        t_h8 = time.perf_counter() - t0
        add_shard_launches()
        s8 = f8.stage1_stats
        same8 = torch.equal(host8, f8.G)
        print(f"int8 store: written from the CSR in {t_w8:.3f} s ({st8.n_shards} shards, "
              f"{st8.stats.bytes_read} B read so far); stage 1 from it {t_f8:.3f} s "
              f"(encode {s8.encode_seconds:.3f} s, {s8.bytes_h2d} wire B, {s8.chunks} "
              f"chunks, launches {cnt8}); the CSR's chunks through the host encoder "
              f"{t_h8:.3f} s; G bit-equal {same8}")
        check(same8 and s8.encode_seconds == 0.0 and cnt8["gram_q8"] == s8.chunks == 15,
              "the int8 store's stored codes did not give the host int8 path's G")
        del host8, f8

        # a data shard corrupted on its first read: quarantined, parsed again
        # from the text, and the factor is the driver's
        store_c = attach_source_rebuilder(ShardStore(os.path.join(shard_root, "data")),
                                          train_svm)
        kp_d = res_r.svm.kernel
        faults.install(faults.FaultPlan().add("shard_corrupt", kind="corrupt", shard=1))
        try:
            reset_counts()
            t0 = time.perf_counter()
            f_c = compute_factor_streamed_shards(
                store_c, kp_d, budget, device=dev,
                config=StreamConfig(device_budget_bytes=256 << 20))
            torch.cuda.synchronize()
            t_c = time.perf_counter() - t0
        finally:
            faults.uninstall()
        add_shard_launches()
        cst = store_c.stats
        same_c = all(torch.equal(getattr(f_c, k), getattr(res_r.svm.factor, k))
                     for k in ("G", "landmarks", "projector", "eigvals"))
        print(f"shard 1 corrupted on read: {cst.checksum_failures} checksum failure, "
              f"{cst.quarantined} quarantined, {cst.rebuilt} rebuilt from the text; "
              f"stage 1 {t_c:.3f} s; factor bit-equal to the driver's {same_c}")
        check(cst.checksum_failures == cst.quarantined == cst.rebuilt == 1 and same_c,
              "a corrupt data shard was not rebuilt bit for bit")
        check(os.path.isfile(os.path.join(shard_root, "data", "quarantine",
                                          "shard_00001.bin")),
              "the corrupt shard was not kept under quarantine/")
        del f_c, res_i, res_r, store_c, store_f

    with phase("stage 2 off a spilled G, full width"):
        # the streamed path's fit with spill_g (stage 1 on the f32 wire, so
        # that B1 makes G and rebuilds its shards): G goes to 4096-row f32
        # shards and stage 2 reads it from disk; the pinned host memory stage
        # 1 allocates is counted; then stage 2 on a pinned copy of the same G.
        # Cut to the main path's first 30000 rows (8 shards; G 246 MB, still
        # past the 256 MiB budget with x): each solve off the disk reads and
        # checks some 45 GB of shards on one host thread at all 60000
        n_sp = 30000
        from repro_torch.core import streaming as streaming_mod
        from repro_torch.core import trace as trace_mod
        from repro_torch.core.shards import GShardView
        spill_dir = os.path.join(libsvm_dir.name, "spill")
        cfg_sp = dataclasses.replace(cfg, stage1_dtype="f32", shard_dir=spill_dir,
                                     spill_g=True)
        pinned = []
        real_hb = streaming_mod.host_buffer

        def counting_host_buffer(shape, dtype, device):
            t = real_hb(shape, dtype, device)
            pinned.append((tuple(shape), t.nbytes))
            return t

        tr_sp = trace_mod.Tracer()
        svm_sp = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2, stream_config=cfg_sp)
        streaming_mod.host_buffer = counting_host_buffer
        try:
            reset_counts()
            t0 = time.perf_counter()
            svm_sp.fit(xtr[:n_sp], ytr[:n_sp], trace=tr_sp)
            wall_sp = time.perf_counter() - t0
        finally:
            streaming_mod.host_buffer = real_hb
        cnt_sp = add_shard_launches()
        G_v = svm_sp.factor.G
        sst = G_v.store.stats
        st_sp = svm_sp.stats
        s1v, s2v = st_sp.stage1_stats, st_sp.stage2_stats
        evs = tr_sp.events()
        fit_sp = {e[2]: e for e in evs if e[1] == "fit"}
        lo2, hi2 = fit_sp["stage2"][3], fit_sp["stage2"][3] + fit_sp["stage2"][4]
        busy_sp, _ = tr_sp.busy("cuda:0 compute", lo2, hi2)
        disk2 = sum(e[4] for e in evs if e[1] == "disk" and e[2] == "shard_read"
                    and lo2 <= e[3] <= hi2)
        print(f"fit with spill_g: {wall_sp:.3f} s (stage 1 {st_sp.stage1_seconds:.3f} s, "
              f"stage 2 {st_sp.stage2_seconds:.3f} s traced); G {type(G_v).__name__} "
              f"{G_v.shape} in {G_v.store.n_shards} shards, {sst.bytes_written} B written "
              f"in {sst.write_seconds:.3f} s; stage 1 pinned {sum(b for _, b in pinned)} B "
              f"in {len(pinned)} buffers, largest {max(r for (r, *_), _ in pinned)} rows "
              f"(a host G would be {n_sp * G_v.shape[1] * 4} B); launches {cnt_sp}")
        print(f"stage 2 off the spilled G: {sst.shards_read} shard reads, {sst.bytes_read} "
              f"B read and {sst.verifications} verified, {sst.read_gbps:.2f} GB/s, reads "
              f"{sst.read_seconds:.3f} s, checksums {sst.verify_seconds:.3f} s; disk spans "
              f"in stage 2 {disk2:.3f} s; compute row busy {busy_sp:.3f} s of "
              f"{hi2 - lo2:.3f}, idle share {1 - busy_sp / (hi2 - lo2):.3f}; {s2v.epochs} "
              f"epochs, {s2v.full_passes} full passes, {s2v.kernel_calls} B2 launches")
        check(isinstance(G_v, GShardView) and G_v.shape[0] == n_sp
              and G_v.store.n_shards == -(-n_sp // 4096), "factor.G is not a spilled view")
        check(max(r for (r, *_), _ in pinned) < n_sp,
              "stage 1 with spill_g allocated a host buffer of n rows")
        check(st_sp.stage1_streamed and st_sp.stage2_streamed
              and cnt_sp["gram"] == 1 + s1v.chunks and cnt_sp["gram_q8"] == 0
              and cnt_sp["smo_epoch"] == s2v.kernel_calls > 0,
              f"the spilled fit's launches {cnt_sp} are not its chunks and blocks")

        # the same G, pinned (a copy for the comparison only), solved
        # uncached at the spilled fit's 256 MiB (whose derived cache holds no
        # block) and cached at the block cache phase's 480 MiB with 224 MiB
        # carved for the cache; then the cached solve off the spilled G, with
        # one G shard corrupted on its first read in the middle of it: B1
        # makes that shard again from its stage-1 chunks, the cache serves
        # blocks of rows gathered from the view, and the solve is the pinned
        # G's all the same
        G_pin = host_buffer(G_v.shape, torch.float32, dev)
        for s0 in range(0, n_sp, 4096):
            G_pin[s0:s0 + 4096].copy_(torch.from_numpy(G_v[s0:s0 + 4096]))
        tasks_sp, cfg_s2 = svm_sp.tasks_, svm_sp.config
        cfg_cached = dataclasses.replace(cfg, device_budget_bytes=480 << 20,
                                         cache_budget_bytes=224 << 20)
        G_v.store._cache.clear()
        runs = {}
        for name, G_run, scfg in (
                ("pinned, uncached", G_pin, dataclasses.replace(cfg, cache_blocks=False)),
                ("pinned, cached", G_pin, cfg_cached),
                ("spilled, cached, shard 3 corrupted", G_v, cfg_cached)):
            before = dataclasses.replace(sst)
            if G_run is G_v:
                faults.install(faults.FaultPlan().add("shard_corrupt", kind="corrupt",
                                                      shard=3))
            try:
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r, rs = solve_batch_streamed(G_run, tasks_sp, cfg_s2, return_stats=True,
                                             stream_config=scfg)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            finally:
                faults.uninstall()
            runs[name] = (r, rs, secs, before, add_shard_launches())
        ru = runs["pinned, uncached"][0]
        same_uncached = (torch.equal(ru.alpha, svm_sp.alpha_) and torch.equal(ru.w, svm_sp.W_)
                         and np.array_equal(ru.epochs.cpu().numpy(), st_sp.epochs))
        rc, rv = runs["pinned, cached"][0], runs["spilled, cached, shard 3 corrupted"][0]
        same_cached = all(torch.equal(getattr(rc, f), getattr(rv, f))
                          and torch.equal(getattr(ru, f), getattr(rv, f))
                          for f in ("alpha", "w", "epochs"))
        for name, (r, rs, secs, _, cnt_r2) in runs.items():
            print(f"stage 2 {name}: {secs:.3f} s, {rs.epochs} epochs, {rs.bytes_g} G bytes "
                  f"over the bus ({rs.bytes_hit} B hit, {rs.cache_hits} blocks), launches "
                  f"{cnt_r2}")
        _, rs_v, t_rv, b0, cnt_rv = runs["spilled, cached, shard 3 corrupted"]
        print(f"the cached solve off the spilled G read {sst.shards_read - b0.shards_read} "
              f"shards, {sst.bytes_read - b0.bytes_read} B in "
              f"{sst.read_seconds - b0.read_seconds:.3f} s "
              f"({(sst.bytes_read - b0.bytes_read) / max(sst.read_seconds - b0.read_seconds, 1e-12) / 1e9:.2f} GB/s), "
              f"checksums {sst.verify_seconds - b0.verify_seconds:.3f} s; shard 3: "
              f"{sst.quarantined - b0.quarantined} quarantined, {sst.rebuilt - b0.rebuilt} "
              f"rebuilt by B1 ({cnt_rv['gram']} launches); alphas, w and epochs bit-equal "
              f"to the pinned G's: the spilled fit's stage 2 (uncached) {same_uncached}, "
              f"cached {same_cached}")
        check(same_uncached and same_cached,
              "stage 2 off the spilled G differs from stage 2 off the pinned G")
        check(s2v.bytes_hit == 0 and rs_v.bytes_hit > 0 and runs["pinned, cached"][1].bytes_hit > 0,
              "the spilled fit's stage 2 hit its cache, or the cached solves served no block")
        check(sst.rebuilt - b0.rebuilt == 1 and sst.quarantined - b0.quarantined == 1
              and cnt_rv["gram"] >= 1, "a corrupt G shard was not rebuilt through B1")
        del G_pin, runs, ru, rc, rv, svm_sp, G_v, evs
    print(f"launches in the shard phases {shard_launches}")
    libsvm_dir.cleanup()
    print(f"launches in the LIBSVM phases {lib_launches}")

    # ------------------------------------------- the multi-device task farm
    # core/distributed.py: a worker (host thread, engine, copy and compute
    # streams) per device entry.  The farm always runs on two entries of the
    # first card, [cuda:0, cuda:0], so one card suffices; with more cards it
    # runs on them too, and the lines say which ran.
    from repro_torch.core import distributed
    from repro_torch.core import trace as trace_mod
    from repro_torch.core.quant import quant_scale_bytes
    from repro_torch.core.resilience import WatchdogTimeout
    pair = [dev, dev]
    n_cards = torch.cuda.device_count()
    layouts = [("two workers on cuda:0", pair)]
    if n_cards > 1:
        layouts.append((f"{n_cards} cards", [torch.device("cuda", i) for i in range(n_cards)]))
    farm_counts = {"gram": 0, "gram_q8": 0, "smo_epoch": 0}
    farm_workers = {}

    def farm_run(G_run, tasks_run, cfg_run, devs, sc, **kw):
        """The farm once, synchronised and timed, its launches counted."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r, s = distributed.solve_tasks_streamed(G_run, tasks_run, cfg_run, devices=devs,
                                                stream_config=sc, return_stats=True, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = read_counts(add=False)
        for k in farm_counts:
            farm_counts[k] += got[k]
        return r, s, secs, got, t0

    def same_fields(a, b, fields=("alpha", "w", "epochs")):
        return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)

    def near(a, b):   # the reference's farm tolerance (tests/test_stage2_mesh.py)
        return (torch.allclose(a.alpha, b.alpha, rtol=1e-4, atol=1e-5)
                and torch.allclose(a.w, b.w, rtol=1e-4, atol=1e-5)
                and torch.equal(a.epochs, b.epochs))

    with phase("task farm, streamed path"):
        # the streamed path's factor (60000 x rank, pinned) and its 45 OVO
        # tasks at its 256 MiB on the f32 wire: one device, then the farm
        # overlapped (one shared reader) and serial (each worker re-reads G)
        G_f, tasks_f, cfg_f = fac_s.G, svm_s.tasks_, svm_s.config
        sc_f = dataclasses.replace(cfg, block_dtype="f32")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_f, s_one = solve_batch_streamed(G_f, tasks_f, cfg_f, stream_config=sc_f,
                                            return_stats=True)
        torch.cuda.synchronize()
        t_one = time.perf_counter() - t0
        l_one = read_counts(add=False)["smo_epoch"]
        print(f"one device: stage 2 {t_one:.3f} s, {s_one.epochs} epochs, {l_one} B2 "
              f"launches, first full pass {s_one.epoch_bytes[0]} B, bytes_h2d "
              f"{s_one.bytes_h2d}, bytes_put {s_one.bytes_put}, G {tuple(G_f.shape)}, "
              f"T {tasks_f.n_tasks}")
        check(s_one.bytes_put == s_one.bytes_h2d, "one device's bytes_put is not bytes_h2d")
        over_pair = None
        for label, devs in layouts:
            for overlap in (True, False):
                r, s, secs, got, _ = farm_run(G_f, tasks_f, cfg_f, devs, sc_f, overlap=overlap)
                per = [p.kernel_calls for p in s.per_device]
                bit = same_fields(r, one_f)
                kind = "overlapped" if overlap else "serial"
                print(f"{label}, {kind}: stage 2 {secs:.3f} s (one device {t_one:.3f} s, "
                      f"{secs / t_one:.3f}x); {s.n_devices} workers, B2 launches a worker "
                      f"{per} (counted {got['smo_epoch']}); epochs {s.epochs}; first full "
                      f"pass {s.epoch_bytes[0]} B ({s.epoch_bytes[0] / s_one.epoch_bytes[0]:.3f}x "
                      f"one device's); bytes_h2d {s.bytes_h2d}, bytes_put {s.bytes_put}; "
                      f"alpha, w, epochs bit-equal to one device {bit}; within rtol 1e-4, "
                      f"atol 1e-5 {near(r, one_f)}")
                # held bit-equal: a task's trajectory does not depend on its
                # worker (B2 sweeps a task a CUDA block), as the card showed
                # from the first run of this phase (the reference's farm
                # tolerance, rtol 1e-4 / atol 1e-5, printed beside it)
                check(bit, f"the {kind} farm ({label}) is not one device's solve bit for bit")
                check(s.n_devices == len(devs) and min(per) > 0
                      and got["smo_epoch"] == s.kernel_calls == sum(per),
                      f"the {kind} farm's B2 launches are not its workers' blocks")
                if overlap:
                    check(s.epoch_bytes[0] == s_one.epoch_bytes[0] and s.bytes_put > s.bytes_h2d,
                          "the overlapped farm's first pass is not one device's bytes")
                    if devs is pair:
                        over_pair = r
                        farm_workers["streamed"] = per
                else:
                    check(s.epoch_bytes[0] >= 1.9 * s_one.epoch_bytes[0],
                          "the serial farm's first pass did not re-read G a worker")
        # traced: each row's idle share over the farm's wall
        tr_f = trace_mod.Tracer()
        r_t, s_t, secs_t, _, t0_t = farm_run(G_f, tasks_f, cfg_f, pair,
                                             dataclasses.replace(sc_f, trace=tr_f))
        t1_t = t0_t + secs_t
        evs_f = tr_f.events()
        rows_f = tr_f.device_tids()
        for row in sorted(set(rows_f.values())):
            busy, gaps = tr_f.busy(row, t0_t, t1_t)
            print(f"traced farm, {row}: busy {busy:.3f} s of {secs_t:.3f}, idle share "
                  f"{1 - busy / secs_t:.3f}, largest gap {(gaps[0][1] - gaps[0][0]) if gaps else 0:.4f} s")
        comp_tids = {t for t, nm in rows_f.items() if nm.endswith(" compute")}
        any_busy = sum(b - a for a, b in trace_mod._merge_intervals(
            [(max(e[3], t0_t), min(e[3] + e[4], t1_t)) for e in evs_f
             if e[0] == "X" and e[5] in comp_tids and e[3] + e[4] > t0_t and e[3] < t1_t]))
        idle_w = {}
        for e in evs_f:
            if e[0] == "X" and e[1] == "queue":
                key = (e[2], e[6].get("device"))
                idle_w[key] = idle_w.get(key, 0.0) + e[4]
        print(f"traced farm: {secs_t:.3f} s; the card's compute (either worker) busy "
              f"{any_busy:.3f} s, idle share {1 - any_busy / secs_t:.3f}; host queue spans "
              f"{ {f'{k[0]} {k[1]}': round(v, 3) for k, v in sorted(idle_w.items())} }; "
              f"bit-equal to the untraced farm {same_fields(r_t, over_pair)}")
        check(same_fields(r_t, over_pair), "the traced farm is not the untraced one")
        check({"cuda:0/w0 compute", "cuda:0/w1 compute"} <= set(rows_f.values()),
              "the traced farm has no device row a worker")
        del r_t, tr_f, evs_f, over_pair

    with phase("task farm, wires and cache"):
        # reduced (6000 x 784, B 512, 45 tasks at C 1, tile 512): the wires'
        # exact first-pass bytes on the overlapped farm (each wire's farm
        # against one device's solve), each engine's block cache against the
        # uncached farm (f32), and the grid task farm's ladders split whole
        # over the two workers against the serial C loop
        xw, yw = make_multiclass(6000, p=784, n_classes=10, sep=0.1, within=0.06, seed=1)
        _, labw = np.unique(yw, return_inverse=True)
        kpw = KernelParams("rbf", gamma=median_gamma(xw))
        facw = compute_factor(xw, kpw, 512, seed=0, device=dev)
        Gw = host_buffer(tuple(facw.G.shape), torch.float32, dev).copy_(facw.G)
        nw, rankw = Gw.shape
        tw, _ = build_ovo_tasks(labw, 10, 1.0, device=dev)
        cfgw = SolverConfig(tol=1e-3, max_epochs=600)
        basew = dict(tile_rows=512, prefetch=2, autotune_prefetch=False)
        firsts = {}
        for wire in ("f32", "bf16", "int8"):
            scw = StreamConfig(**basew, block_dtype=wire)
            onew, s1w = solve_batch_streamed(Gw, tw, cfgw, stream_config=scw, return_stats=True)
            rw, sw, secs, got, _ = farm_run(Gw, tw, cfgw, pair, scw)
            firsts[wire] = sw.epoch_bytes[0]
            print(f"reduced, {wire} blocks on two workers: first full pass {sw.epoch_bytes[0]} "
                  f"B (one device {s1w.epoch_bytes[0]}); {secs:.3f} s; hits {sw.cache_hits} "
                  f"blocks {sw.bytes_hit} B over the workers "
                  f"({[p.bytes_hit for p in sw.per_device]}); bit-equal to one device "
                  f"{same_fields(rw, onew)}")
            check(sw.epoch_bytes[0] == s1w.epoch_bytes[0],
                  f"the {wire} farm's first pass is not one device's bytes")
            check(same_fields(rw, onew) and sw.bytes_hit > 0,
                  f"the {wire} farm is not one device's solve, or its caches served nothing")
            if wire == "f32":
                ru, su, secs_u, _, _ = farm_run(Gw, tw, cfgw, pair,
                                                dataclasses.replace(scw, cache_blocks=False))
                print(f"reduced, f32, the farm uncached: {secs_u:.3f} s; the cached farm "
                      f"bit-equal to it {same_fields(rw, ru)}, hits + misses "
                      f"{sw.bytes_hit + sw.bytes_miss} B against its misses {su.bytes_miss} B")
                check(same_fields(rw, ru) and sw.bytes_hit + sw.bytes_miss == su.bytes_miss,
                      "the farm's caches are not exact, or their bytes do not add up")
        nb = -(-nw // 512)
        eff = solver_stream.wire_group(512, StreamConfig(**basew, block_dtype="int8"))
        g32, g8 = nw * rankw * 4, nb * (512 * rankw + quant_scale_bytes(512, eff))
        print(f"byte model: f32 {g32} B (real rows), bf16 {g32 // 2} B, int8 {g8} B (tiles "
              f"padded, groups of {eff} rows); measured {firsts}")
        check(firsts["f32"] == g32 and firsts["f32"] - firsts["bf16"] == g32 // 2
              and firsts["f32"] - firsts["int8"] == g32 - g8,
              "the farm's wire bytes are not the byte model")

        # the grid task farm: C 1/16 -> 1/4 ladders, every epoch a full pass,
        # against the serial streamed C loop, each cell warm from the last
        masks_w = cv.kfold_masks(len(xw), 3, 0)
        Cs_w = [1 / 16, 1 / 4]
        p1 = SolverConfig(tol=1e-2, max_epochs=1000, full_pass_period=1)
        f_sc = StreamConfig(device_budget_bytes=256 << 20, prefetch=2, autotune_prefetch=False)
        warm, serial_w = None, []
        for C in Cs_w:
            t_c, _ = cv.build_cv_tasks(labw, 10, C, masks_w, warm=warm, device=dev)
            serial_w.append(solve_batch_streamed(Gw, t_c, p1, stream_config=f_sc))
            warm = serial_w[-1].alpha
        gt, _, ch = cv.build_cv_grid_tasks(labw, 10, Cs_w, masks_w, ladder=True, device=dev)
        lad, lst, secs, got, _ = farm_run(Gw, gt, dataclasses.replace(
            p1, max_epochs=2 * p1.max_epochs + 2), pair, f_sc, chain_next=ch)
        FP = lad.alpha.shape[0] // len(Cs_w)
        cells = [slice(ci * FP, (ci + 1) * FP) for ci in range(len(Cs_w))]
        same_a = all(torch.equal(lad.alpha[k], r.alpha) for k, r in zip(cells, serial_w))
        same_e = all(torch.equal(lad.epochs[k], r.epochs) for k, r in zip(cells, serial_w))
        shares = distributed.balance_chain_split((gt.c > 0).sum(1).cpu().numpy(),
                                                 ch, 2)
        whole = all(ch[t] < 0 or ch[t] in p for p in shares for t in p)
        print(f"ladder farm on two workers, T {gt.n_tasks} ({[len(p) for p in shares]} tasks "
              f"a worker, every ladder whole {whole}): {secs:.3f} s, {lst.epochs} epochs, B2 "
              f"launches a worker {[p.kernel_calls for p in lst.per_device]}; per-cell alphas "
              f"equal to the serial C loop's {same_a}, epochs {same_e}")
        check(whole and same_a and same_e, "the ladder farm is not the serial C loop")
        del facw, serial_w, lad, gt

    with phase("task farm, faults"):
        # the reduced problem on two workers: a device loss at worker 1, a
        # kill at the third full pass and its resume, a stalled reader
        scw = StreamConfig(**basew)
        clean, s_clean, _, _, _ = farm_run(Gw, tw, cfgw, pair, scw)
        _, s_alone = solve_batch_streamed(Gw, tw, cfgw, stream_config=scw, return_stats=True)
        plan = faults.install(faults.FaultPlan().add("h2d", kind="persistent",
                                                     device="cuda:0/w1", epoch=1))
        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err):
                lost, s_lost, secs, got, _ = farm_run(
                    Gw, tw, cfgw, pair, dataclasses.replace(scw, fail_fast=False))
        finally:
            faults.uninstall()
        print(f"device loss at cuda:0/w1 (epoch 1): fired {len(plan.fired)}; "
              f"{err.getvalue().strip()}; re-splits {s_lost.resplits}, ended on "
              f"{s_lost.n_devices} worker(s) in {secs:.3f} s; alpha, w, epochs bit-equal "
              f"to the clean farm {same_fields(lost, clean)}; epoch bytes equal to a "
              f"clean run on the survivor (one worker) "
              f"{s_lost.epoch_bytes == s_alone.epoch_bytes}")
        check(len(plan.fired) == 1 and s_lost.resplits == 1 and s_lost.n_devices == 1
              and "re-split" in err.getvalue(), "the lost worker was not re-split")
        check(same_fields(lost, clean), "the re-split farm is not the clean run")
        check(s_lost.epoch_bytes == s_alone.epoch_bytes,
              "the re-split farm's per-epoch bytes are not the survivor's clean run's")

        ck_farm = tempfile.TemporaryDirectory()
        sck = dataclasses.replace(scw, checkpoint_dir=ck_farm.name, checkpoint_every=1)
        third = 2 * cfgw.full_pass_period      # full passes at epochs 0, 20, 40
        check(s_clean.full_passes > 3, "the clean farm ran fewer than four full passes")
        faults.install(faults.FaultPlan().add("epoch_boundary", kind="kill", epoch=third))
        killed = False
        try:
            farm_run(Gw, tw, cfgw, pair, sck)
        except faults.SimulatedKill:
            killed = True
        finally:
            faults.uninstall()
        res_k, s_k, secs, got, _ = farm_run(Gw, tw, cfgw, pair,
                                            dataclasses.replace(sck, resume=True))
        print(f"farm killed at the third full pass (epoch {third}): {killed}; resumed from "
              f"epoch {s_k.resumed_from} in {s_k.resume_seconds:.3f} s, {secs:.3f} s; "
              f"bit-equal to the clean farm {same_fields(res_k, clean)}; epoch bytes equal "
              f"{s_k.epoch_bytes == s_clean.epoch_bytes}")
        check(killed and s_k.resumed_from == third + 1 and same_fields(res_k, clean),
              "the resumed farm is not the uninterrupted one")
        ck_farm.cleanup()

        faults.install(faults.FaultPlan().add("stall", kind="stall", block=2))
        watchdog = 2.0
        t0 = time.perf_counter()
        tripped = ""
        try:
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                distributed.solve_tasks_streamed(
                    Gw, tw, cfgw, devices=pair,
                    stream_config=dataclasses.replace(scw, watchdog_seconds=watchdog))
        except WatchdogTimeout as exc:
            tripped = str(exc)
        finally:
            t_trip = time.perf_counter() - t0
            faults.uninstall()         # releases the parked worker
        for th in [t for t in threading.enumerate() if t.name.startswith("worker/")]:
            th.join(timeout=30)
        left = [t.name for t in threading.enumerate() if t.name.startswith("worker/")]
        torch.cuda.synchronize()
        print(f"a stall at the reader's hand-off (block 2) under watchdog_seconds "
              f"{watchdog}: WatchdogTimeout after {t_trip:.3f} s: "
              f"{tripped.splitlines()[0] if tripped else 'none'}; worker threads left "
              f"{left}")
        check(bool(tripped) and "worker/cuda:0/w" in tripped and t_trip <= watchdog + 5.0,
              "the stalled farm did not raise WatchdogTimeout in time")
        check(not left, "a farm worker thread outlived its release")
        del Gw, tw, clean, lost, res_k

    with phase("stage 1 over devices"):
        # the streamed path's stage 1 (60000 x 784, 256 MiB) on both wires,
        # its chunks handed out round-robin to two workers: G bit-equal to
        # one device's
        s1_workers = {}
        for wire in ("f32", "int8"):
            c1 = dataclasses.replace(cfg, stage1_dtype=wire)
            one1 = compute_factor_streamed(xtr, kp, budget, config=c1, device=dev)
            for label, devs in layouts:
                reset_counts()
                t0 = time.perf_counter()
                f2 = distributed.compute_factor_streamed_mesh(devs, xtr, kp, budget,
                                                              stream_config=c1)
                secs = time.perf_counter() - t0
                got = read_counts(add=False)
                for k in farm_counts:
                    farm_counts[k] += got[k]
                st2 = f2.stage1_stats
                same = torch.equal(f2.G, one1.G)
                k_chunk = "gram_q8" if wire == "int8" else "gram"
                print(f"stage 1, {wire} wire, {label}: {secs:.3f} s (one device "
                      f"{one1.stage1_stats.seconds:.3f} s pipeline, this {st2.seconds:.3f}); "
                      f"{st2.chunks} chunks, a worker {st2.device_chunks}; launches {got}; "
                      f"G bit-equal to one device's {same}")
                check(same, f"stage 1 over devices ({wire}) is not one device's G")
                check(len(st2.device_chunks) == len(devs) and min(st2.device_chunks) > 0
                      and got[k_chunk] == st2.chunks + (1 if k_chunk == "gram" else 0),
                      f"stage 1's {k_chunk} launches are not its workers' chunks")
                if devs is pair:
                    s1_workers[k_chunk] = st2.device_chunks
            del one1, f2

    with phase("driver --no-overlap"):
        # the driver's streamed run (reduced backbone, 400 documents) with
        # --no-overlap, in this process, with the local device list patched
        # to [cuda:0, cuda:0]: LPDSVM.fit -> solve_streamed_auto -> the
        # serial farm, each worker re-reading G.  Its stage-2 line names two
        # devices, each worker launches B2, and the farm's first pass is
        # twice one device's bytes on the same G and tasks.
        out = io.StringIO()
        real_local, real_farm = solver_stream.local_devices, distributed.solve_tasks_streamed
        seen = []

        def farm_seen(G_run, tasks_run, cfg_run, **kw):
            r, s = real_farm(G_run, tasks_run, cfg_run, **{**kw, "return_stats": True})
            seen.append((G_run, tasks_run, cfg_run, kw, s))
            return (r, s) if kw.get("return_stats") else r

        solver_stream.local_devices = lambda device: [dev, dev]
        distributed.solve_tasks_streamed = farm_seen
        reset_counts()
        try:
            with contextlib.redirect_stdout(out):
                driver.main(["--classes", "3", "--n", "400", "--seq", "16", "--budget", "64",
                             "--stream", "--no-overlap"])
        finally:
            solver_stream.local_devices = real_local
            distributed.solve_tasks_streamed = real_farm
        got = read_counts(add=False)
        for k in farm_counts:
            farm_counts[k] += got[k]
        s2_line = [ln for ln in out.getvalue().splitlines() if ln.startswith("stage2 stream:")]
        print(out.getvalue(), end="")
        check(len(seen) == 1 and not seen[0][3].get("overlap", True),
              "the driver's stage 2 did not go through the serial farm once")
        G_d, tasks_d, cfg_d, kw_d, st_d = seen[0]
        _, one_d = solver_stream.solve_batch_streamed(
            G_d, tasks_d, cfg_d, stream_config=kw_d.get("stream_config"),
            chain_next=kw_d.get("chain_next"), return_stats=True)
        w_calls = [p.kernel_calls for p in (st_d.per_device or [])]
        print(f"driver --no-overlap on [cuda:0, cuda:0]: launches {got}; B2 launches a "
              f"worker {w_calls}; first pass {st_d.epoch_bytes[0]} B against one "
              f"device's {one_d.epoch_bytes[0]} B")
        check(bool(s2_line) and "2 device(s)" in s2_line[0],
              "the driver's stage-2 line does not print its two devices")
        check(st_d.n_devices == 2 and len(w_calls) == 2 and min(w_calls) > 0,
              "a worker of the driver's serial farm launched no B2")
        check(st_d.epoch_bytes[0] == 2 * one_d.epoch_bytes[0],
              "the serial farm's first pass is not twice one device's bytes")
        check(got["smo_epoch"] > 0 and got["flash_attention"] > 0,
              "the driver with --no-overlap launched no B2 or no B4")
    print(f"launches in the task-farm phases {farm_counts}")

    # the LM serving path: B4 is its one kernel (the prefill step); decode's
    # attention is plain tensor ops, as the reference's einsums are
    reset_counts()
    served = serve_phases(dev, smi.splitlines()[0], compare_flash)
    serve_counts = read_counts(add=False)
    print(f"launches in the serving phases {serve_counts}; B4 a prefill step "
          f"{served['b4_launches']}")
    check(serve_counts["gram"] == serve_counts["gram_q8"] == serve_counts["smo_epoch"] == 0,
          "the serving path launched an SVM kernel")

    # the paper's Table 2 comparators (B1, B2, E1) and the LM training path
    # (B4 and its gradient); each fit and run resets the counts it reads
    table2 = table2_phases(dev, smi.splitlines()[0])
    trained = train_phases(dev, smi.splitlines()[0])
    e1 = table2["e1"]

    with phase("driver --arch rwkv6-1.6b"):
        # the paper's driver on the attention-free backbone, as the
        # reference's main builds it (reduced rwkv6, seed 0, the CLI's
        # defaults: 2000 documents of 64 tokens, 10 classes, budget 256), in
        # this process: its head (B1, B2) beats chance; no B4.  (At 400
        # documents of 16 tokens and 3 classes the reference's own driver
        # gives 0.65 against chance 0.67 on this backbone: too few test
        # documents to tell its weak signal from chance.)
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):
            err = driver.main(["--arch", "rwkv6-1.6b"])
        rwkv_driver = read_counts(add=False)
        print(out.getvalue(), end="")
        print(f"driver --arch rwkv6-1.6b: test error {err:.4f} (chance 0.90); "
              f"launches {rwkv_driver}")
        check(err < 0.9, "the driver's head on rwkv6 features does not beat chance")
        check(rwkv_driver["gram"] > 0 and rwkv_driver["smo_epoch"] > 0
              and rwkv_driver["flash_attention"] == 0,
              "the driver on rwkv6 did not launch B1 and B2, or launched B4")

    with phase("driver --arch deepseek-v2-236b"):
        # the same on the reduced MLA backbone (2 layers, 4 heads, q / k 96
        # wide, v 64): B4 at (96, 64) once a layer a batch of 32 documents
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):
            err = driver.main(["--arch", "deepseek-v2-236b"])
        ds_driver = read_counts(add=False)
        print(out.getvalue(), end="")
        n_batches = -(-2000 // 32)
        print(f"driver --arch deepseek-v2-236b: test error {err:.4f} (chance 0.90); "
              f"launches {ds_driver} (B4: 2 layers x {n_batches} batches expected)")
        check(err < 0.9, "the driver's head on deepseek-v2 features does not beat chance")
        check(ds_driver["gram"] > 0 and ds_driver["smo_epoch"] > 0
              and ds_driver["flash_attention"] == 2 * n_batches,
              "the driver on deepseek-v2 did not launch B1 and B2, or B4 once a layer a batch")

    kernels = [
        {"name": "gram", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gram.cu",
         "replaces": "src/repro/kernels/gram.py:70", "launches": launches["gram"],
         "max_abs_err": gram_err, "ms": g_ms, "plain_ms": g_plain,
         "bound_ms": g_bound, "bound_by": g_by, "library_ms": g_lib,
         "bound_ms_cuda_cores": g_bound_cc, "ms_back_to_back": g_b2b,
         "ms_predict": pr_ms, "ms_predict_back_to_back": pr_b2b, "bound_ms_predict": pr_bound,
         "ms_at_scale": b1b_ms, "ms_at_scale_back_to_back": b1b_b2b,
         "bound_ms_at_scale": b1b_bound, "launches_grid": g_launches["gram"],
         "launches_libsvm": lib_launches["gram"], "launches_trace": t_launches["gram"],
         "launches_shards": shard_launches["gram"],
         "launches_task_farm": farm_counts["gram"],
         "launches_stage1_workers": s1_workers["gram"],
         "launches_table2": table2["launches"]["gram"],
         "launches_driver_rwkv6": rwkv_driver["gram"],
         "launches_driver_deepseek": ds_driver["gram"]},
        {"name": "smo_epoch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/smo.cu",
         "replaces": "src/repro/kernels/smo.py:100",
         "launches": launches["smo_epoch"], "max_abs_err": smo_err, "ms": s_ms,
         "plain_ms": s_plain, "bound_ms": s_bound, "bound_by": s_by,
         "library_ms": None, "ms_cheap": cheap_ms, "launches_grid": grid_smo_launches,
         "ms_t135": t135_ms, "ms_cheap_t135": t135_cheap, "waves_t135": waves,
         "launches_farm": farm_launches["full width"],
         "launches_farm_reduced": farm_launches["reduced"],
         "launches_compact": c_launches, "launches_libsvm": lib_launches["smo_epoch"],
         "launches_trace": t_launches["smo_epoch"], "launches_int8_blocks": i8_launches,
         "launches_block_cache": cache_launches,
         "launches_shards": shard_launches["smo_epoch"],
         "launches_task_farm": farm_counts["smo_epoch"],
         "launches_task_farm_workers": farm_workers["streamed"],
         "launches_table2": table2["launches"]["smo_epoch"],
         "launches_driver_rwkv6": rwkv_driver["smo_epoch"],
         "launches_driver_deepseek": ds_driver["smo_epoch"]},
        {"name": "gram_q8", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gram_q8.cu",
         "replaces": "src/repro/kernels/gram.py:157",
         "launches": s_launches["gram_q8"], "max_abs_err": q8_err, "ms": q8_ms,
         "plain_ms": q8_plain, "bound_ms": q8_bound, "bound_by": q8_by,
         "library_ms": q8_lib, "bound_ms_cuda_cores": q8_bound_cc,
         "ms_back_to_back": q8_b2b, "ms_at_scale": q8b_ms,
         "bound_ms_at_scale": q8b_bound, "launches_libsvm": lib_launches["gram_q8"],
         "launches_trace": t_launches["gram_q8"],
         "launches_shards": shard_launches["gram_q8"],
         "launches_task_farm": farm_counts["gram_q8"],
         "launches_stage1_workers": s1_workers["gram_q8"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:68",
         "launches": e2e["flash_attention"], "max_abs_err": flash_err,
         **flash_times["qwen3-0.6b pipeline"], "shapes": flash_times,
         "launches_libsvm": lib_launches["flash_attention"],
         "launches_shards": shard_launches["flash_attention"],
         "launches_serving": sum(served["b4_launches"].values()),
         "launches_serving_by_arch": served["b4_launches"],
         "launches_train": sum(trained["b4_launches"].values()),
         "launches_train_by_arch": trained["b4_launches"],
         "launches_driver_deepseek": ds_driver["flash_attention"],
         "gradient_of_bound": trained["grad_worst"], "gradient_ms": trained["grad_ms"]},
        {"name": "exact_epoch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/exact_epoch.cu",
         "replaces": "src/repro/baselines/exact_smo.py:29",
         "launches": table2["launches"]["exact_epoch"], "max_abs_err": e1["max_abs_err"],
         "ms": e1["ms"], "plain_ms": e1["plain_ms"], "bound_ms": e1["bound_ms"],
         "bound_by": e1["bound_by"], "library_ms": None, "n": e1["n"],
         "moving_steps": e1["moved"], "ns_still_step": e1["ns_still_step"],
         "ns_moving_step": e1["ns_moving_step"]},
    ]
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel of the main paths was launched no time")
    check(all(table2["launches"][k] > 0 for k in ("gram", "smo_epoch", "exact_epoch"))
          and min(trained["b4_launches"].values()) > 0,
          "a kernel of the Table 2 fits or of training was launched no time")
    check(all(lib_launches[k] > 0 for k in ("gram", "gram_q8", "smo_epoch")),
          "a kernel of the LIBSVM route was launched no time")
    check(all(shard_launches[k] > 0 for k in ("gram", "gram_q8", "smo_epoch")),
          "a kernel of the shard phases was launched no time")
    check(all(farm_counts[k] > 0 for k in ("gram", "gram_q8", "smo_epoch"))
          and min(farm_workers["streamed"]) > 0
          and min(s1_workers["gram"] + s1_workers["gram_q8"]) > 0,
          "a kernel of the task-farm phases was launched no time, or by no worker")
    check(all(t_launches[k] > 0 for k in ("gram", "gram_q8", "smo_epoch")) and i8_launches > 0
          and cache_launches > 0,
          "a kernel of the traced fit, the int8 or the cached stage 2 was launched no time")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
