"""Drive repro_torch on one NVIDIA Hopper card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device   — require CUDA and compute capability 9.x; print the card's
                name and power limit (nvidia-smi)
  2. build    — build the CUDA kernels from src/repro_torch/kernels/csrc
                and import the libraries of srht.cu and codec.cu as the
                extension modules repro_srht and repro_codec; print the
                registers and spills (ptxas) of both flash kernels per
                instantiation (the tf32x3 one may not spill at D <= 128),
                of every codec kernel instantiation, of the forward
                SRHT's and the strided pass's register kernels and of both
                flash backward routes' kernels (none of these may spill)
  3. parity   — hold fwht, srht_apply and srht_apply_t against their
                plain PyTorch versions on the card, in float32 and
                float64, at power-of-two and padded dims (dim = n - 1
                too), batched, at the quickstart's, the full-size SUSY,
                covtype and phishing shapes and on both sides of every
                route boundary (fwht.kernel_route), k = 1 and k = n, at
                (2000, 5000) -> n 8192 (more chunks than one wave of
                blocks, so each block walks several), with signs other
                than +1 and -1 on every route, and srht_apply on views of
                x off a 16-byte boundary; then srht_apply with one operator
                per leading index (signs (G, n), rows (G, k)) on every
                forward route: one row an operator, odd groups, groups
                that straddle a chunk, k = 1 and k = n, the FedNS shapes,
                signs other than +-1 and a view off a 16-byte boundary;
                then srht_rows_kernel (srht_apply_rows, A (G, n_rows, M)
                read in place) at every slab size that fits, at the FedNS
                shapes cut in clients, one client, k = 1 and k = n, rows
                off a power of two, a wide row, with those signs and
                views: bit-equality required (the kernels keep the plain
                versions' op order and are built with -fmad=false)
  4. quickstart — FLeNS at the quickstart size (n=4000, dim=64, m=8,
                k=32, float64, 12 rounds) through the kernels; launch
                counts checked per round (3 srht_apply + 2 srht_apply_t,
                one batched launch per call site); the trajectory must
                equal the same run through the plain versions on the card
  5. full size — the SUSY twin at the real row count (n=5,000,000, M=18,
                m=1000, k=10, lam=1e-3, float64): newton_solve, then FLeNS
                for 10 rounds; gap per round, ms per round, peak memory,
                and each kernel's time at its main-path shapes beside its
                bound, the plain version and the library yardstick
                (srht_apply_t also at the quickstart's shapes, fwht also at
                (64, 2^14)); for fwht and srht_apply_t the profiler's
                device time and the kernel that serves the shape, and for
                srht_apply_t the host's launch path step by step (10,000
                calls a step) beside the parent commit's way of each step
 5b. covtype  — the covtype twin at the real UCI row count (n=581,012,
                M=54, m=200, k=20, lam=1e-3, spectrum_decay 1.8, float64):
                newton_solve, then FLeNS for 10 rounds through the kernels
                (3 srht_apply + 2 srht_apply_t launches a round) with the
                trajectory equal to the plain versions' on the card; gap
                per round, ms per round (run_rounds and bare), peak memory,
                a profiled round's device busy share and top kernels; then
                srht_apply at covtype's three main-path shapes, phishing's
                (11,055 rows, M=68, m=40, k=17), the quickstart's and one
                FedNS-like call ((18,000, 5,000) -> n 8192, k 10, one
                operator), each with its route, events time, the profiler's
                device time in all and by kernel, the bound, the plain
                version and x @ S.T, and bit-equal to the plain version
  5c. table-I — the nine other Table-I optimizers (FedAvg, FedProx,
                FedNewton, DistributedNewton, LocalNewton, FedNew, FedNL,
                FedNS with k=10, FedNDES) on the SUSY problem at full size,
                10 rounds each with comm=None: loss finite and gap falling,
                gap per round, ms per round (run_rounds and bare), peak
                memory; FedNS and FedNDES launch one srht_apply_rows a
                round (srht_rows_kernel, counted under srht_apply too) and
                their trajectories equal the plain versions' on the card
                (each with profiled rounds, which must hold no copy of the
                clients' A); then srht_apply_rows at the three FedNS
                shapes (SUSY 1000 x 5000 rows x 18 -> n 8192, k 10;
                covtype 200 x 2906 x 54 -> 4096, k 20; the quickstart 8 x
                500 x 64 -> 512, k 32), in turns with the parent's way (A's
                transpose copy, then the batched srht_apply kernel): events,
                the profiler's device time by kernel (which must find the
                kernel), the copy on its own, the bound, the plain version
                and torch.bmm of dense per-client S; and FedNS srht:fixed
                under one
                CommConfig at the quickstart size, its trajectory, bytes
                and traces equal to the plain versions'
 5d. async   — FLeNS+ at SUSY's size on the straggler channel: the
                full-quorum anchor bit-equal to sync, then sync, async_buf
                (K = m/4), async_q50 and async_buf under comp+sched+ef,
                launches checked (4 srht_apply + 3 srht_apply_t a group
                round, one probe round a run), trajectories equal to the
                plain versions', ms a commit with the event loop apart
 5e. populations — the lock-step anchor across the population drivers at
                m = 200, then a child process: m = 100,000 at q = 1e-3
                under the edge codecs with EF (sync and async) and SUSY's
                rows as a DatasetPopulation, against host and device
                budgets; the child also runs 5f's two population drivers
                and 5g's population rows
 5f. telemetry — run_rounds with obs=TelemetryConfig(sink="jsonl:...")
                on five drivers: FLeNS without transport (10 rounds),
                FLeNS+ under comp+sched+ef on the edge channel (10 rounds,
                its first two profiled), async_buf (K = m/4) on the
                straggler channel (20 commits) at SUSY's full size, and
                the m = 100,000 population's sync (10 rounds) and async
                (10 commits) runs from the 5e child: each trajectory
                bit-equal to the run with telemetry off, the launches
                checked, the JSONL accepted by repro_torch.obs.report
                --check-schema; compile_s, exec_s_per_round, phase_s and
                the flight stats printed, with ms a step with telemetry
                off, on with the null sink and on with the jsonl sink (three
                turns each); the profiler's Chrome trace must name
                srht_fwd_warp_kernel, srht_t_warp_kernel,
                topk_mask_warp_kernel and qint8_warp_kernel at 2 x (4 / 3
                / 1 / 3) launches (streams and traces under
                chiprun_out/telemetry/)
 5g. dynamics — FLeNS+ at SUSY's full size under scenario dynamics
                (repro_torch.dynamics), telemetry on: churn (poisson:0.05)
                with a diurnal uplink (sin:24,0.5) and regional outages
                (outage:0.05,3,16) under comp+sched+ef on the edge
                channel, sync 10 rounds (its first two profiled: the trace
                must name the four warp kernels at 2 x (4 / 3 / 1 / 3)
                launches) and async_buf (K = m/4) 20 commits; then
                bench_robust's arms (clean, signflip:0.1, signflip:0.1 with
                trimmed:0.1) under the dense codecs on the straggler
                channel, sync 10 rounds each; and from the 5e child, the
                m = 100,000 population rows of examples/edge_clients.py
                at uniform:1e-3, 10 rounds each (churn; clean, noise:0.1,5
                and noise:0.1,5 with trimmed:0.1 under the dense codecs).
                Each run: launches checked, the trajectory and the dynamics
                counters bit-equal to the plain versions' on the card, the
                counters (robust_stats, clients_departed, uploads_retired)
                and the alive count printed; the arms of a comparison
                transmit equal bytes (checked), their final-loss gaps to
                the clean run printed; bare ms a step with dynamics off and
                on in turns (off, on, on, off) printed beside each other
 5h. distributed — DistributedFLeNS (repro_torch.core.distributed) at
                SUSY's full size (5,000,000 x 18 float64, k 10, beta 0, 10
                rounds): (a) one NCCL rank on a ("data",) DeviceMesh of 1,
                the whole dataset one client, within 1e-10 (relative) of
                the simulator FLeNS(k, beta=0, restart=False) at m = 1 on
                the same rows and operators, a round profiled (the
                device's busy share); (b) 4 ranks on the one card, gloo
                over CUDA tensors (child processes `chip_smoke.py
                --distributed-child`, which load the built kernels and are
                joined with a timeout), 1,250,000 rows each: every rank's
                iterates bit-equal to the others' and within 1e-10 of the
                simulator's at m = 4. Launches checked on each rank (3
                srht_apply + 2 srht_apply_t a round); ms a round beside the
                simulator's on the same rows
 5i. client mesh — SUSY's rows as a DatasetPopulation of m 1000
                (uniform:0.1, a cohort of 100) under phase 5e's edge channel
                and comp+sched+ef's codecs with EF, FLeNS+ 10 rounds through
                run_rounds(..., client_mesh=): (a) one NCCL rank, the
                cohort's one block, bit-equal to the run without a mesh
                (iterates, losses, bytes, traces, EF residuals); (b) 4 gloo
                ranks on the card (children `chip_smoke.py
                --client-mesh-child`), 25 clients of each cohort a rank,
                bit-equal to each other and within 1e-10 of the one-process
                run; (c) the async driver on the straggler channel, 5
                commits, the same way. Launches checked on every rank (4
                srht_apply + 3 srht_apply_t + 1 topk_mask + 3
                qint8_roundtrip a round); ms a round a rank beside the
                one-process run's, a profiled round each. (d) moe_apply's
                backward, one arctic-480b layer at its widths with 8 of its
                128 experts in float32: the expert branch on a ("model",)
                mesh of 2 gloo ranks and the decode branch on (2 data, 2
                model), each rank's gradients of x, the router and its
                expert shard within 1e-4 of the one-process backward's
                largest on the card
 6. long rows — fwht, srht_apply and srht_apply_t past the single-pass
                length (n = 2^15, 2^17, 2^20) against their plain versions,
                bit-equal; fwht timed at (64, 2^17) and (1, 2^20),
                srht_apply at (2, 2^17) with dim 2^17 - 5, each with the
                profiler's device time by kernel (the two passes apart)
  7. codec parity — topk_mask and qint8_roundtrip against their plain
                versions, bit-equal, in float32 and float64: the main-path
                payload shapes, ties, zero rows, kept = 1 and P, ragged
                widths, the warp routes' limit (P = 1024) and one past it,
                and long rows that are streamed
  8. transport — FLeNS+ at the SUSY size under two transports of
                examples/edge_clients.py (comp+sched+ef, crush+rot+ef) on
                its edge channel, 10 rounds each: codec launches per round
                as the codec chains imply, the guarded loss finite and
                never rising, the same trajectory and byte axis through
                the plain versions on the card; bytes, simulated seconds,
                ms per round, peak memory, and the codec kernels' times
                (events and the profiler's device time, with the kernel
                that serves each shape) beside their bounds, plain
                versions and library yardstick, and the host's launch path
                of qint8_roundtrip at (1000, 55) step by step beside the
                parent commit's ctypes way
  9. flash parity — the flash-attention kernels against their plain
                version (ref.mha_blocked): bfloat16 through the tensor-core
                kernel (route sm90, max abs err <= 2e-2), float32 through
                the 3xTF32 tensor-core kernel (route tf32x3, <= 2e-5), each
                launch counted on its route: (tq, tk) in (64, 64), (100,
                100), (32, 96),
                (1, 128), (2048, 2048) x (H, Hkv) in (4, 4), (8, 1),
                (32, 4) x D in 64, 128, 256, then windows 1, 7, 128, 512
                (D 128 and 256 at 2048), 10 heads on one KV head at D 256
                (windows 32 and 2048), D 8 and 112, non-causal (whisper's
                encoder among them: (1500, 6, 6, 64), a ragged last key
                tile), q_offset with a window, rows with no key, causal
                rows of up to 4096 and 8192 keys (D 64, 128), gemma3-4b's
                (8192, 8, 4, 256) with window 1024 and causal; then head
                dims that are
                not a multiple of 8 (D 12, 13, 200 in float32; D 12, 13 in
                bfloat16, which TMA cannot stride) through the tf32x3
                kernel
 10. serve    — TinyLlama-1.1B at full width and depth (22 layers, bf16,
                random weights from seed 0) through ServingEngine
                (max_batch 4, cache_len 4096): 8 requests, prompts of
                100-2000 tokens (numpy seed 0), 64 new tokens each; every
                request completes, 22 launches of the tensor-core kernel per
                prefill (none of the tf32x3 one) and none in decode; the
                last-position logits of a 2048-token prefill
                through the kernel and the plain version within 4 bf16
                ulps of the largest logit; prefill ms by bucket (128 to
                2048), decode ms per step at batch 4 and its profile,
                engine tokens/s, peak memory, and the kernel's profiled
                share of a 2048-token prefill
 11. serve f32 — the same model in float32 (TF32 off), 22 tf32x3-kernel
                launches per prefill (none of the sm90 one): every
                request's engine tokens equal its isolated prefill + greedy
                decode; engine tokens/s, the 2048-token prefill's ms and
                its profile (device time, the flash kernel's share)
 11b. recurrent — mamba2-780m (48 ssd layers) and recurrentgemma-2b (8
                griffin super-blocks + 2 rec layers) at full width and
                depth in bf16 (random weights from seed 0) through
                ServingEngine with serve's 8 prompts, 16 new tokens each
                (64 before phase 14 trained every kind): the engine admits
                each prompt unpadded (mamba2: the longest multiple of its
                256-token chunk through prefill, the rest through
                decode_step); launches: none for mamba2, 8 sm90 a prefill
                for recurrentgemma, none in decode; recurrentgemma's
                2048-token prefill logits through the kernel within 4 bf16
                ulps of the plain version's; prefill ms by length (128 to
                2048), decode ms per step at batch 4, engine tokens/s, peak
                memory, a profiled prefill. Their float32 twins (TF32 off,
                6 and 8 layers; mamba2's 12 before): engine tokens equal
                each request's isolated generation, the 2048-token
                prefill's logits
                within 1e-3 of the plain versions', its ms and profile
                (phase 11's steps). One LM.loss forward and backward each
                at 1 x 2048 tokens with remat: recurrentgemma's CE and
                gradients within phase 13's tolerances of the plain
                versions', 16 forward and 8 sm90 backward launches;
                mamba2's finite; both timed
 11c. moe     — arctic-480b (2 of its 35 layers, 55.4 GB) and
                kimi-k2-1t-a32b (its dense layer and one moe layer of 61,
                39.8 GB) at full width in bf16 (random weights from seed
                0) through ServingEngine with serve's 8 requests: 2 sm90
                launches a prefill, none in decode; the 2048-token
                prefill through the kernels and the plain versions: the
                expert choices and keeps that flip between them counted,
                the logits within 4 bf16 ulps where none flips, every
                attention layer's kernel within 2e-2 of its plain version
                on the layer's own q, k, v, each moe layer's drop
                fraction; prefill ms by bucket, decode ms at batch 4,
                engine tokens/s, peak memory, a profiled prefill. Their
                float32 twins (arctic 1 layer; kimi 2 layers with 128 of
                its 384 experts): the engine's tokens equal each request
                alone through a one-slot engine (the same bucketed
                capacity), the logits within 1e-3 where no route flips.
                arctic's LM.loss forward and backward at 1 layer, 1 x
                2048 tokens, remat: 2 forward and one sm90 backward (7
                runs of 1 head and a sum pass), loss = ce + 0.01 aux, CE,
                aux and every gradient against the plain versions' within
                phase 13's tolerances where no route flips, peak memory,
                ms
 11d. cross   — whisper-tiny whole (4 non-causal encoder and 4 dec layers)
                and llama-3.2-vision-90b at 30 of its 100 layers (6 vlm
                super-blocks of 4 self layers and a gated cross layer,
                55.56 GB; every width kept) in bf16, random weights from
                seed 0, the vlm's zero-initialised gates drawn U(0.5, 1.0)
                (printed): launch/serve.py's batched prefill and greedy
                decode (whisper 4 x 128 tokens over 4 x 1500 frames, 64
                new tokens, cache 192; the vision model 4 x 512 tokens
                over 4 x 1601 x 1280 patch embeddings, 64 new, cache 576);
                launches a prefill: whisper 4 non-causal and 4 causal sm90,
                the vision model 24 causal, none in decode; the prefill's
                logits (whisper's batch, the vision model's batch-1 2048
                tokens) and whisper's encoder output through the kernels
                within 4 bf16 ulps of the plain versions'; prefill, the
                encoder alone and decode ms, tokens/s, peak memory, a
                profiled prefill with the cross attention a named range,
                one cross layer's float32 products alone. The float32
                twins (TF32 off; whisper whole, the vision model at 5
                layers) on the tf32x3 kernel: the batch's tokens equal
                each row generated alone at batch 1. One LM.loss forward
                and backward each in bf16 with remat: whisper 8 x 448
                tokens over 8 x 1500 frames (12 forward and 8 backward
                launches, 4 of each non-causal: the encoder runs once), the
                vision model at 5 layers on 1 x 2048 (8 + 4); CE and every
                gradient (the gates' among them) within phase 13's
                tolerances of the plain versions', peak memory, ms
 11e. rightsized — gemma3-1b@rightsized (4 dense_sb super-blocks of 5
                local layers with rings of 512 slots and a global one, and
                a remainder of 2 local layers with rings) and
                gemma3-4b@rightsized (5 super-blocks, rings of 1024, a
                remainder of 4) whole in bf16, random weights from seed 0,
                through ServingEngine at their published contexts (cache
                32,768 and 131,072): serve's 8 prompts and one of 32,768
                tokens, 16 new tokens each (64 before phase 14 trained
                every kind), each prompt prefilled whole; launches 26 / 34 sm90
                a prefill, none in decode; the decode state's bytes
                beside the uniform caches' (from shapes), peak memory,
                tokens/s, decode at batch 4 near the context's end with
                its profile and the caches' float32 upcast timed alone,
                prefill ms at 128 to 32,768 tokens with a profile of the
                longest; the 2048-token prefill's logits through the
                kernels within 4 bf16 ulps of the plain versions'. One
                LM.loss forward and backward each at 1 x 4096 tokens with
                remat (52 + 26 and 68 + 34 launches), CE and gradients
                within phase 13's tolerances. Right-sized against uniform
                on the same weights (gemma3-1b whole, a 1000-token prompt,
                cache 4096): prefill logits bit-equal, 64 decode steps
                within 2e-2 of max |logit|. The float32 twin (gemma3-1b
                whole, TF32 off; serve's 8 prompts, 16 new tokens each):
                the engine's tokens equal each request's isolated
                generation (phase 11's steps)
 11f. mesh serving — LMs served over a mesh, 4 gloo ranks on the one
                card (children `chip_smoke.py --mesh-serving-child`) in
                the reference's serving layout: qwen1.5-110b (4 layers,
                bf16, a 4-way model mesh), TinyLlama whole on (2 data, 2
                model) with the engine, its float32 twin (streams equal
                to no mesh), one NCCL rank bit-equal to no mesh
 11g. mesh recurrent — the recurrent kinds the same way: mamba2-780m (4
                layers, bf16, a 4-way model mesh: 12 SSD heads a rank),
                recurrentgemma-2b (4 layers: a griffin super-block and a
                rec layer, bf16, (2, 2): 5 q heads and half the RG-LRU
                width a rank) with the engine, its float32 twin (logits
                within 1e-5 of max |logit|, streams equal to no mesh), one
                NCCL rank each bit-equal to no mesh
 11h. mesh rings cross — right-sized rings and cross attention the same
                way: gemma3-4b@rightsized (8 layers, bf16, a 4-way model
                mesh: 256 of each 1024-slot ring a rank; 1 x 2048 past
                the window, 4 x 1020 whose steps wrap the rings),
                gemma3-1b@rightsized (8 layers, bf16, (2, 2)) with the
                engine (4 prompts of 300-700 tokens admitted unpadded) and
                its float32 twin (logits within 1e-4 of max |logit|,
                streams equal to no mesh), whisper-tiny whole (bf16, (2,
                2): 3 of 6 heads a rank, 4 x 128 over 4 x 1500 frames,
                the encoder non-causal) and its float32 twin,
                llama-3.2-vision-90b (5 layers, bf16, a 4-way model mesh,
                1 x 2048 over 1601 vision tokens, gates drawn as 11d's),
                one NCCL rank each for gemma3-1b@rightsized and
                whisper-tiny bit-equal to no mesh. In 11f-11h: each
                rank's parameter and decode-state bytes equal to its
                shard's, the bf16 logits within 2x the no-mesh run's error
                + 1 ulp of a float32 yardstick, the flash launches a
                prefill a rank on the rank's heads by (causal, window),
                the kernel held against its plain version at each
                distinct call, ms and collective bytes a step
 12. flash times — the tensor-core kernel, its plain version and
                F.scaled_dot_product_attention at (1, 2048, 32, 4, 64)
                causal, (1, 2048, 4, 1, 256) window 512, (1, 2048, 64,
                8, 128) causal, (1, 2048, 10, 1, 256) window 2048, and
                arctic's (1, 2048, 56, 8, 128) and kimi-k2's (1, 2048, 64,
                8, 112) causal, whisper's encoder (1, 1500, 6, 6, 64)
                non-causal (its bound counts all T^2 pairs), gemma3-4b's
                (1, 2048, 8, 4, 256) window 1024 and (1, 32768, 8, 4, 256)
                causal (SDPA on K and V repeated to every head), bf16, beside
                the bound; the tf32x3 kernel at the first three shapes and
                whisper's in float32, beside its bound (three
                times the operations at the 494.7 TFLOP/s dense TF32 tensor
                rate) and the float32 SIMT one (67 TFLOP/s), SDPA with TF32
                off
 13. train    — LM training through the flash-attention backward kernels
                (route sm90: csrc/flash_attention_bwd_sm90.cu, bf16 with D
                % 8 == 0; route tf32x3: csrc/flash_attention_bwd.cu, 3xTF32
                on mma.sync, the rest): (a) the backward against its plain
                version
                (ref.mha_blocked_grad) at (1, 2048, 32, 4, 64) and (1,
                2048, 64, 8, 128) causal, (1, 2048, 4, 1, 256) window 512,
                the training shape (2, 2048, 32, 4, 64), recurrentgemma's
                (1, 2048, 10, 1, 256) window 2048, (1, 1024, 8, 2, 60),
                arctic's (1, 2048, 56, 8, 128) and kimi-k2's (1, 2048, 64,
                8, 112) causal, whisper's encoder (1, 1500, 6, 6, 64)
                non-causal, gemma3-4b's (1, 2048, 8, 4, 256) window 1024,
                in bfloat16 (<= 2e-2 of each gradient's max
                |value|; D 64, 128 and 256 on sm90, D 60 on tf32x3) and
                float32 (<= 1e-4, tf32x3), and gemma3-4b's (1, 32768, 8,
                4, 256) causal in bfloat16 (the plain version by blocks of
                2048 queries), each launch counted on its route,
                a second call bit-equal, a failing sm90 and tf32x3 entry
                point raising with nothing launched, the forward's output
                bit-equal with
                its log-sum-exp written and not (also over flash parity's
                self-attention shapes, causal and not), timed beside its bound, its plain
                version and SDPA's backward; (b) TinyLlama-1.1B at full
                width and depth in bf16 with remat, batch 2 x 2048 tokens
                from FastLMStream, 12 AdamW steps with launch/train.py's
                schedule, through the kernels (2 forward launches and 1
                sm90 backward a layer a step, none of the tf32x3 backward)
                and through the plain versions from the same init: every
                CE finite, the trajectories and step 0's gradients within
                the stated tolerances, the last CE below the first; ms a
                step, tokens/s, peak memory and a profiled step's busy
                share, backward-kernel share and top host ops; (c) the
                float32 twin at full width and 4 layers (the tf32x3
                forward, the tf32x3 backward), the same checks at tight
                tolerances; (d) the FLeNS head (m = 8, 64 sequences of 32
                tokens a client, k = 64) on the trained bf16 backbone's
                features (D = 2048): FLeNS through the SRHT kernels
                bit-equal to the plain versions, with FedAvg and FedNewton
 14. mesh train — LM training over a mesh (LM.loss, train_step and
                adamw_update under sharding.ctx.use_mesh) in the
                reference's train_4k layout: every leaf of the
                parameters, gradients and AdamW moments its block under
                rules.param_spec (FSDP over data, heads, SSD heads, RG-LRU
                width, MLP width, experts and vocab over model), the
                batch's rows over data; 4 gloo ranks on the one card
                (children `chip_smoke.py --mesh-train-child`, drawing the
                weights from the seed one after another), each part's
                run without a mesh in this process first from the same
                weights and batches: (a) TinyLlama-1.1B whole in bf16
                with remat on (2 data, 2 model), 2 x 2048 tokens (one row
                a data rank), 3 AdamW steps; (b) its float32 twin at 4
                layers (the tf32x3 forward and backward); (c) arctic-480b
                at full width, 1 layer and 8 of its 128 experts, float32,
                one AdamW step on the moe decode branch ((2, 2)) and one
                on the expert branch (a 4-way model mesh); (d)
                mamba2-780m at full width, 4 layers, bf16, (2, 2), 2
                steps; (e) recurrentgemma-2b at full width, one (rec,
                rec, attn) super-block, bf16, (2, 2), 2 steps; (f)
                gemma3-4b@rightsized at full width, one super-block (5
                local layers at window 1024, a global one), bf16, model 4,
                2 steps; (g) whisper-tiny whole in float32, (2, 2), 2 x
                448 tokens over 2 x 1500 frames, 2 steps (the encoder's
                non-causal tf32x3 backward); (h) llama-3.2-vision-90b at
                full width, one super-block (4 self layers, a cross layer
                over 1601 vision tokens), bf16, model 4, step 0's loss and
                gradients alone (its AdamW moments do not fit beside the
                no-mesh run). Every step's CE equal on all ranks and
                within phase 13's tolerance (bf16; float32 1e-5) of the
                no-mesh run's, step 0's gradient blocks within phase 13's
                (bf16) or 1e-5 of max |g| (float32; arctic 1e-4), each
                rank's parameter and moment bytes the layout's, the flash
                launches a step a rank on the rank's heads (2 forward and
                1 backward a self-attention layer, 1 and 1 an encoder
                layer, none in mamba2), the forward and backward kernels
                held against their plain versions at each of the rank's
                distinct calls; ms a step a rank beside the no-mesh run's,
                the collectives' bytes and host ms a step by kind
                (forward gather / sum / max, backward reduce_scatter /
                sum_bwd), peak memory a rank
 15. kernels  — one JSON line naming every ported kernel (flash
                attention as two entries: the sm90 route and the tf32x3
                route; its backward as two more: the sm90 route, timed and
                counted on the bf16 training run, and the tf32x3 route, on
                the f32 twin's); the srht_apply and fwht entries list their
                routes, each with a timed shape and its bound (srht_apply's
                batched routes at the three FedNS shapes too)

The last line of standard output is the device record
``{"ok": true, "device": {...}}``; before it come the card's name and
power limit, the kernels line, and the whole run's record as one JSON
line prefixed ``[record]``.

The script imports nothing of JAX; it finds the port under src/ next to
itself and fails when run anywhere else.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, the vector (non
# tensor-core) rates the butterfly and codec kernels run on, and the
# dense bf16 tensor-core rate that bounds attention on bf16 inputs
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float64: 34e12, torch.float32: 67e12,
                  torch.bfloat16: 989e12}
# the dense TF32 tensor-core rate: the tf32x3 flash kernel does three TF32
# products for each float32 one
TF32_OPS_PER_S = 494.7e12

SUSY = dict(n=5_000_000, dim=18, m=1000, k=10, lam=1e-3,
            spectrum_decay=1.5, label_noise=0.05)
QUICK = dict(n=4000, dim=64, m=8, k=32, lam=1e-3)
# paper Table II covtype at the real UCI row count (repro's twin cuts it
# to 58,101 rows for the CPU) and phishing (its real size)
COVTYPE = dict(n=581_012, dim=54, m=200, k=20, lam=1e-3, spectrum_decay=1.8,
               label_noise=0.05)
PHISHING = dict(n=11_055, dim=68, m=40, k=17)

KERNELS = {
    "fwht": dict(source="src/repro_torch/kernels/csrc/srht.cu",
                 replaces="src/repro/kernels/fwht.py:51"),
    "srht_apply": dict(source="src/repro_torch/kernels/csrc/srht.cu",
                       replaces="src/repro/kernels/srht.py:98"),
    "srht_apply_t": dict(source="src/repro_torch/kernels/csrc/srht.cu",
                         replaces="src/repro/kernels/srht.py:130"),
    # srht_rows_kernel: srht_apply_pallas under jax.vmap along the clients'
    # data axes (FedNS, FedNDES), A read in place
    "srht_apply_rows": dict(source="src/repro_torch/kernels/csrc/srht.cu",
                            replaces="src/repro/kernels/srht.py:98"),
    "topk_mask": dict(source="src/repro_torch/kernels/csrc/codec.cu",
                      replaces="src/repro/kernels/codec_kernels.py:85"),
    "qint8_roundtrip": dict(source="src/repro_torch/kernels/csrc/codec.cu",
                            replaces="src/repro/kernels/codec_kernels.py:112"),
    "flash_attention_sm90": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        replaces="src/repro/kernels/flash_attention.py:72"),
    "flash_attention_tf32x3": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:72"),
    # no Pallas backward: the reference differentiates mha_blocked's jnp
    # ops, reached from its attention
    "flash_attention_bwd_sm90": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
        replaces="src/repro/models/attention.py:104"),
    "flash_attention_bwd_tf32x3": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:104"),
}
NO_CODEC = {"topk_mask": 0, "qint8_roundtrip": 0}
# srht_rows_kernel's own count (FedNS's and FedNDES's data-axis sketch; its
# launches count under srht_apply too)
NO_ROWS = {"srht_apply_rows": 0}
# (operators G, rows a operator as an inner batch, dim, n, k): batched
# srht_apply on every forward route (n <= 32, 33..2^14, past 2^14): one
# row an operator, odd groups, groups that straddle a chunk of the
# register kernel (13 rows of n = 64, whose chunks hold 64 rows), k = 1
# and k = n, and the three FedNS shapes cut in operators
BATCHED = [(5, (1,), 18, 32, 10), (7, (3,), 30, 32, 1), (3, (33,), 32, 32, 32),
           (9, (13,), 54, 64, 20), (4, (65,), 63, 64, 64), (3, (7,), 500, 512, 1),
           (6, (64,), 500, 512, 32), (3, (54,), 2906, 4096, 20),
           (11, (18,), 5000, 8192, 10), (2, (3,), 16383, 16384, 16384),
           (3, (2,), 20000, 1 << 15, 64), (2, (1,), (1 << 17) - 5, 1 << 17, 300)]
# (G, n_rows, M, n, k): srht_rows_kernel, srht_apply_rows read in place:
# the three FedNS shapes cut in clients, one client, k = 1 and k = n, rows
# under one slab and off a power of two, a row wider than a 32 KB slab,
# the longest single-pass n
ROWS = [(100, 5000, 18, 8192, 10), (20, 2906, 54, 4096, 20),
        (8, 500, 64, 512, 32), (1, 5000, 18, 8192, 10), (3, 100, 7, 128, 1),
        (2, 64, 5, 64, 64), (4, 61, 3, 64, 64), (5, 13, 4, 16, 16),
        (2, 1000, 300, 1024, 8), (2, 16383, 2, 16384, 20)]
# the nine Table-I baselines at examples/federated_logreg.py's settings,
# FedNS at SUSY's k (paper Table II)
TABLE_ONE = [("fedavg", dict(lr=2.0, local_steps=5)),
             ("fedprox", dict(lr=2.0, local_steps=5, mu_prox=0.01)),
             ("fednewton", {}), ("distributed_newton", {}),
             ("local_newton", {}), ("fednew", {}), ("fednl", {}),
             ("fedns", dict(k=SUSY["k"])), ("fedndes", {})]
SKETCHED = ("fedns", "fedndes")  # one batched srht_apply launch a round
# the backward's counters: its total, each route's, and each kernel's
# (route_delta, route_dkdv, route_dq and, when the group's heads are cut
# into runs, route_sum)
BWD_ROUTE_KERNELS = {route: (f"{route}_delta", f"{route}_dkdv", f"{route}_dq")
                     for route in ("sm90", "tf32x3")}
NO_BWD = {"flash_attention_bwd": 0,
          **{f"flash_attention_bwd_{name}": 0
             for route, kernels in BWD_ROUTE_KERNELS.items()
             for name in (route, *kernels, f"{route}_sum")}}
NO_LM = {"flash_attention": 0, "flash_attention_sm90": 0,
         "flash_attention_tf32x3": 0, **NO_BWD}

# examples/edge_clients.py: name -> (sketch, codecs, uplink bytes per
# delivering client at k=10, M=18)
TRANSPORTS = {
    "comp+sched+ef": ("srht", {"h_sk": "sympack+qint8", "sg": "qint8",
                               "grad": "topk0.1+qint8"}, 59 + 14 + 14 + 8),
    "crush+rot+ef": ("srht:rotate=6", {"h_sk": "topk0.25", "sg": "topk0.5",
                                       "grad": "topk0.1+qint8"},
                     300 + 60 + 14 + 8),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    major, minor = torch.cuda.get_device_capability(0)
    check(major == 9, f"needs compute capability 9.x, card has {major}.{minor}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} capability "
        f"{major}.{minor}, torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    return card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    per_source = _build.build_all()
    _build.library()
    _build.module()  # srht.cu is also the extension module repro_srht
    _build.module("codec")  # and codec.cu the extension module repro_codec
    total = time.perf_counter() - t0
    log(f"[build] {total:.2f} s ({per_source or 'already built'})")
    # ptxas -v of the tensor-core flash kernel: one entry per head-dim width
    ptxas = {}
    for entry in re.split(r"Compiling entry function",
                          _build.build_log("flash_attention_sm90"))[1:]:
        name = re.search(r"kernelILi(\d+)E", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        check(name and regs and spill, "build: unreadable ptxas report")
        key = f"D{name.group(1)}"
        ptxas[key] = {"registers": int(regs.group(1)),
                      "spill_stores": int(spill.group(1)),
                      "spill_loads": int(spill.group(2))}
        log(f"[build] flash_attention_sm90_kernel {key}: {ptxas[key]}")
    check(len(ptxas) == 3, f"build: expected 3 sm90 instantiations, got "
          f"{sorted(ptxas)}")
    # the tf32x3 flash kernel: per input type, head-dim width and load path
    # (cp.async or plain loads); no spill at D <= 128
    tf32x3 = {}
    for entry in re.split(r"Compiling entry function",
                          _build.build_log("flash_attention"))[1:]:
        name = re.search(r"tf32x3_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E",
                         entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        check(name and regs and spill, "build: unreadable tf32x3 ptxas report")
        dt, width, cp = name.groups()
        key = (f"{'float' if dt == 'f' else 'bf16'} D{width} "
               f"{'cp.async' if cp == '1' else 'plain loads'}")
        tf32x3[key] = {"registers": int(regs.group(1)),
                       "spill_stores": int(spill.group(1)),
                       "spill_loads": int(spill.group(2))}
        log(f"[build] flash_attention_tf32x3_kernel {key}: {tf32x3[key]}")
        check(int(width) > 128 or tf32x3[key]["spill_stores"]
              == tf32x3[key]["spill_loads"] == 0,
              f"build: tf32x3 {key} spills: {tf32x3[key]}")
    check(len(tf32x3) == 9, f"build: expected 9 tf32x3 instantiations, got "
          f"{sorted(tf32x3)}")
    # the codec kernels: the warp routes' per dtype and register count
    # (values a lane), whose limit holds only without spills, and the
    # block routes' (qint8_kernel with and without 16-byte loads)
    codec = {}
    for entry in re.split(r"Compiling entry function",
                          _build.build_log("codec"))[1:]:
        name = re.search(r"(topk_mask_warp|qint8_warp|topk_mask|qint8)"
                         r"_kernelI([df])(?:Li(\d+)E|Lb([01])E)?", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        check(name and regs and spill, "build: unreadable codec ptxas report")
        kind, dt, values, vec = name.groups()
        args = ["double" if dt == "d" else "float"]
        if values:
            args.append(values)
        if vec:
            args.append("16-byte" if vec == "1" else "single")
        key = f"{kind}_kernel<{', '.join(args)}>"
        codec[key] = {"registers": int(regs.group(1)),
                      "spill_stores": int(spill.group(1)),
                      "spill_loads": int(spill.group(2))}
        check(codec[key]["spill_stores"] == codec[key]["spill_loads"] == 0,
              f"build: {key} spills: {codec[key]}")
    check(len(codec) == 30, f"build: expected 30 codec kernel instantiations, "
          f"got {sorted(codec)}")
    log("[build] codec kernels, registers (no spills): " + ", ".join(
        f"{k} {v['registers']}" for k, v in sorted(codec.items())))
    # the SRHT source's register kernels: the forward one per dtype, LOG_N
    # (6..14) and operator form (one, or one per group of rows), the
    # strided pass per dtype and LOG_R (1..14), the in-place forward along
    # A's rows per dtype and LOG_P (0..4)
    srht = {}
    for entry in re.split(r"Compiling entry function",
                          _build.build_log("srht"))[1:]:
        name = re.search(r"(srht_fwd_reg|fwht_strided|srht_rows)_kernelI([df])"
                         r"Li(\d+)E(?:Lb([01])E)?", entry)
        if not name:
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        check(regs and spill, "build: unreadable srht ptxas report")
        kind, dt, log2, batched = name.groups()
        form = {None: "", "0": ", one operator", "1": ", batched"}[batched]
        key = f"{kind}_kernel<{'double' if dt == 'd' else 'float'}, {log2}{form}>"
        srht[key] = {"registers": int(regs.group(1)),
                     "spill_stores": int(spill.group(1)),
                     "spill_loads": int(spill.group(2))}
        check(srht[key]["spill_stores"] == srht[key]["spill_loads"] == 0,
              f"build: {key} spills: {srht[key]}")
    # the tf32x3 backward's kernels: delta and the split sum per dtype, dk/dv
    # and dq per dtype, head-dim width and load path (float32 by cp.async
    # or plain loads, bfloat16 plain loads); none may spill
    flash_bwd = {}
    for entry in re.split(r"Compiling entry function",
                          _build.build_log("flash_attention_bwd"))[1:]:
        name = re.search(r"flash_bwd_(delta|sum|dkdv|dq)_tf32x3_kernel"
                         r"I(f|13__nv_bfloat16)(?:Li(\d+)ELb([01])E)?", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        check(name and regs and spill, "build: unreadable flash_bwd ptxas "
              "report")
        kind, dt, width, cp = name.groups()
        args = ["float" if dt == "f" else "bf16"]
        if width:
            args += [width, "cp.async" if cp == "1" else "plain loads"]
        key = f"flash_bwd_{kind}_tf32x3_kernel<{', '.join(args)}>"
        flash_bwd[key] = {"registers": int(regs.group(1)),
                          "spill_stores": int(spill.group(1)),
                          "spill_loads": int(spill.group(2))}
        check(flash_bwd[key]["spill_stores"] == flash_bwd[key]["spill_loads"]
              == 0, f"build: {key} spills: {flash_bwd[key]}")
    kinds = [key.split("_tf32x3")[0] for key in flash_bwd]
    check(len(flash_bwd) == 22 and kinds.count("flash_bwd_dkdv") == 9
          and kinds.count("flash_bwd_dq") == 9, f"build: expected 22 "
          f"flash_bwd tf32x3 kernel instantiations (delta, sum 2; dkdv, dq "
          f"9), got {sorted(flash_bwd)}")
    log("[build] tf32x3 flash backward kernels, registers (no spills): "
        + ", ".join(f"{k} {v['registers']}"
                    for k, v in sorted(flash_bwd.items())))
    # the sm90 backward's kernels: delta and the split sum once, dk/dv and
    # dq per head-dim width (64, 128, 256); none may spill
    flash_bwd_sm90 = {}
    for entry in re.split(r"Compiling entry function",
                          _build.build_log("flash_attention_bwd_sm90"))[1:]:
        name = re.search(r"flash_bwd_(delta|sum|dkdv|dq)_sm90_kernel"
                         r"(?:ILi(\d+)E)?", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        check(name and regs and spill, "build: unreadable flash_bwd_sm90 "
              "ptxas report")
        kind, width = name.groups()
        key = f"flash_bwd_{kind}_sm90_kernel" + (f"<{width}>" if width else "")
        flash_bwd_sm90[key] = {"registers": int(regs.group(1)),
                               "spill_stores": int(spill.group(1)),
                               "spill_loads": int(spill.group(2))}
        check(flash_bwd_sm90[key]["spill_stores"]
              == flash_bwd_sm90[key]["spill_loads"] == 0,
              f"build: {key} spills: {flash_bwd_sm90[key]}")
    check(len(flash_bwd_sm90) == 8, f"build: expected 8 flash_bwd_sm90 "
          f"kernel instantiations, got {sorted(flash_bwd_sm90)}")
    log("[build] sm90 flash backward kernels, registers (no spills): "
        + ", ".join(f"{k} {v['registers']}"
                    for k, v in sorted(flash_bwd_sm90.items())))
    kinds = [key.split("_kernel")[0] for key in srht]
    check(kinds.count("srht_fwd_reg") == 36 and kinds.count("fwht_strided")
          == 28 and kinds.count("srht_rows") == 10, f"build: expected 36 "
          f"srht_fwd_reg, 28 fwht_strided and 10 srht_rows instantiations, "
          f"got {sorted(srht)}")
    log("[build] srht register kernels, registers (no spills): " + ", ".join(
        f"{k} {v['registers']}" for k, v in sorted(srht.items())))
    return {"seconds": total, "per_source": per_source,
            "flash_sm90_ptxas": ptxas, "flash_tf32x3_ptxas": tf32x3,
            "codec_ptxas": codec, "srht_ptxas": srht,
            "flash_bwd_ptxas": flash_bwd,
            "flash_bwd_sm90_ptxas": flash_bwd_sm90}


# ---------------------------------------------------------------------------
# 3. parity on the card
# ---------------------------------------------------------------------------

def _operator(gen, n, k, dtype, dev):
    signs = (2 * torch.randint(0, 2, (n,), generator=gen, device=dev)
             - 1).to(dtype)
    rows = torch.randperm(n, generator=gen, device=dev)[:k]
    return signs, rows


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def phase_parity() -> dict:
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    cases = [  # (dim, n, k, batch)
        (64, 64, 32, (8, 500)), (64, 64, 32, (8,)), (64, 64, 32, (32,)),
        (64, 64, 32, ()),  # quickstart: A_j, gradients, S S^T, delta
        (18, 32, 10, (1000, 5000)), (18, 32, 10, (1000,)),
        (18, 32, 10, (10,)), (18, 32, 10, ()),  # the full-size shapes
        (100, 128, 7, (3, 7)), (1, 1, 1, (5,)), (5, 8, 3, (7, 9)),
        (10000, 16384, 50, (3,)),  # the largest transform
        # both sides of each route boundary (fwht.kernel_route), k = 1 and
        # k = n: the register transpose to n = 1024, fwht without shared
        # memory to n = 512, with one exchange from n = 1024 to 2^14
        (2, 2, 1, (5,)), (2, 2, 2, (5,)), (32, 32, 1, (33,)),
        (32, 32, 32, (33,)), (64, 64, 1, (9,)), (61, 64, 64, (9,)),
        (512, 512, 256, (5,)), (1000, 1024, 1, (3,)),
        (1024, 1024, 1024, (3,)), (2048, 2048, 100, (2,)),
        (16384, 16384, 1, (2,)), (16383, 16384, 16384, (2,)),
        # covtype's and phishing's main-path shapes (A_j, gradients, S^T I_k)
        (54, 64, 20, (200, 2906)), (54, 64, 20, (200,)), (54, 64, 20, (20,)),
        (68, 128, 17, (40, 277)), (68, 128, 17, (40,)), (68, 128, 17, (17,)),
        # dims just under n, and the far side of the single-pass limit
        (63, 64, 20, (65,)), (127, 128, 17, (33,)), (1023, 1024, 50, (5,)),
        (16383, 16384, 20, (3,)), (32768, 32768, 1, (2,)),
        # 2000 rows of n = 8192: more chunks than one wave of resident
        # blocks, so each block of the forward register kernel takes
        # several (its mbarrier's parity flips between them)
        (5000, 8192, 10, (2000,)),
    ]
    worst = {name: 0.0 for name in ("fwht", "srht_apply", "srht_apply_t")}
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(1)
        for dim, n, k, batch in cases:
            signs, rows = _operator(gen, n, k, dtype, dev)
            x = torch.randn(batch + (dim,), generator=gen, dtype=dtype,
                            device=dev)
            y = torch.randn(batch + (k,), generator=gen, dtype=dtype,
                            device=dev)
            xp = torch.randn(batch + (n,), generator=gen, dtype=dtype,
                             device=dev)
            pairs = {
                "srht_apply": (ops.srht_apply(x, signs, rows, impl="cuda"),
                               ops.srht_apply(x, signs, rows, impl="ref")),
                "srht_apply_t": (
                    ops.srht_apply_t(y, signs, rows, dim, impl="cuda"),
                    ops.srht_apply_t(y, signs, rows, dim, impl="ref")),
                "fwht": (ops.fwht(xp, normalize=True, impl="cuda"),
                         ops.fwht(xp, normalize=True, impl="ref")),
            }
            torch.cuda.synchronize()
            for name, (got, want) in pairs.items():
                err = _max_err(got, want)
                worst[name] = max(worst[name], err)
                check(torch.equal(got, want),
                      f"{name} {dtype} dim={dim} n={n} k={k} batch={batch}: "
                      f"kernel differs from the plain version "
                      f"(max abs err {err:.3e})")
            del x, y, xp, pairs
    # srht_apply on views of x off a 16-byte boundary (the kernels read the
    # slab's aligned middle by a bulk copy, its ends value by value)
    views = [(54, 64, 20, (200, 37)), (68, 128, 17, (33,)),
             (1023, 1024, 50, (3,)), (16383, 16384, 20, (2,)),
             (18, 32, 10, (40,))]
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(3)
        per = 128 // torch.finfo(dtype).bits  # values of 16 bytes
        for dim, n, k, batch in views:
            signs, rows = _operator(gen, n, k, dtype, dev)
            count = math.prod(batch) * dim
            flat = torch.randn(count + per, generator=gen, dtype=dtype,
                               device=dev)
            for off in range(1, per):
                x = flat[off:off + count].view(batch + (dim,))
                check(x.data_ptr() % 16 != 0, "parity: view is aligned")
                got = ops.srht_apply(x, signs, rows, impl="cuda")
                want = ops.srht_apply(x, signs, rows, impl="ref")
                err = _max_err(got, want)
                worst["srht_apply"] = max(worst["srht_apply"], err)
                check(torch.equal(got, want),
                      f"srht_apply {dtype} dim={dim} n={n} k={k} batch="
                      f"{batch} view {off} values off a 16-byte boundary: "
                      f"kernel differs from the plain version (max abs "
                      f"err {err:.3e})")
    # signs other than +1 and -1 (standard normal, with some exactly +1,
    # -1 and -0.0) on every route of both SRHT forms: the forward register
    # kernel multiplies by the sign as read where it cannot use the bits
    signed = [(18, 32, 10, (40,)), (54, 64, 20, (300,)),
              (1023, 1024, 50, (9,)), (5000, 8192, 10, (700,)),
              (16383, 16384, 20, (3,)), (20000, 1 << 15, 64, (2,))]
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(7)
        for dim, n, k, batch in signed:
            _, rows = _operator(gen, n, k, dtype, dev)
            signs = torch.randn(n, generator=gen, dtype=dtype, device=dev)
            signs[:3] = torch.tensor([1.0, -1.0, -0.0], dtype=dtype)
            x = torch.randn(batch + (dim,), generator=gen, dtype=dtype,
                            device=dev)
            y = torch.randn(batch + (k,), generator=gen, dtype=dtype,
                            device=dev)
            for name, got, want in (
                    ("srht_apply", ops.srht_apply(x, signs, rows, impl="cuda"),
                     ops.srht_apply(x, signs, rows, impl="ref")),
                    ("srht_apply_t",
                     ops.srht_apply_t(y, signs, rows, dim, impl="cuda"),
                     ops.srht_apply_t(y, signs, rows, dim, impl="ref"))):
                err = _max_err(got, want)
                worst[name] = max(worst[name], err)
                check(torch.equal(got, want),
                      f"{name} {dtype} dim={dim} n={n} k={k} batch={batch} "
                      f"with signs other than +-1: kernel differs from the "
                      f"plain version (max abs err {err:.3e})")
    # srht_apply with one operator per leading index (FedNS's per-client
    # sketches), on every forward route: each case with +-1 signs, with
    # signs other than +-1, and on a view of x off a 16-byte boundary
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(8)
        for g, inner, dim, n, k in BATCHED:
            x = torch.randn((g,) + inner + (dim,), generator=gen, dtype=dtype,
                            device=dev)
            signs = (2 * torch.randint(0, 2, (g, n), generator=gen, device=dev)
                     - 1).to(dtype)
            rows = torch.stack([torch.randperm(n, generator=gen,
                                               device=dev)[:k]
                                for _ in range(g)])
            odd = torch.randn((g, n), generator=gen, dtype=dtype, device=dev)
            odd[:, :3] = torch.tensor([1.0, -1.0, -0.0], dtype=dtype)
            flat = torch.randn(x.numel() + 1, generator=gen, dtype=dtype,
                               device=dev)
            view = flat[1:].view(x.shape)
            check(view.data_ptr() % 16 != 0, "parity: view is aligned")
            for what, xx, ss in (("+-1 signs", x, signs),
                                 ("signs other than +-1", x, odd),
                                 ("a view off a 16-byte boundary", view, odd)):
                got = ops.srht_apply(xx, ss, rows, impl="cuda")
                want = ops.srht_apply(xx, ss, rows, impl="ref")
                err = _max_err(got, want)
                worst["srht_apply"] = max(worst["srht_apply"], err)
                check(torch.equal(got, want),
                      f"batched srht_apply {dtype} G={g} rows {inner} dim="
                      f"{dim} n={n} k={k} with {what}: kernel differs from "
                      f"the plain version (max abs err {err:.3e})")
    # srht_rows_kernel (srht_apply_rows, A read in place), called alone
    # whatever the route, at every slab size that fits: the same inputs
    worst["srht_apply_rows"] = _rows_parity(dev)
    torch.cuda.synchronize()
    log(f"[parity] {len(cases)} shapes x 2 dtypes x 3 kernels, "
        f"{len(views)} misaligned srht_apply views x 2 dtypes, "
        f"{len(signed)} shapes with signs other than +-1 x 2 dtypes x 2 "
        f"kernels, {len(BATCHED)} batched srht_apply shapes x 3 inputs x "
        f"2 dtypes and {len(ROWS)} srht_rows_kernel shapes x 3 inputs x 2 "
        f"dtypes at each slab bit-equal to the plain versions (max abs err "
        f"{worst})")
    return worst


def _rows_parity(dev) -> float:
    from repro_torch.kernels import fwht as kfwht
    from repro_torch.kernels import ops
    from repro_torch.kernels import srht as ksrht

    worst = 0.0
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(9)
        for g, n_rows, m, n, k in ROWS:
            a = torch.randn((g, n_rows, m), generator=gen, dtype=dtype,
                            device=dev)
            signs = (2 * torch.randint(0, 2, (g, n), generator=gen, device=dev)
                     - 1).to(dtype)
            rows = torch.stack([torch.randperm(n, generator=gen,
                                               device=dev)[:k]
                                for _ in range(g)])
            odd = torch.randn((g, n), generator=gen, dtype=dtype, device=dev)
            odd[:, :3] = torch.tensor([1.0, -1.0, -0.0], dtype=dtype)
            flat = torch.randn(a.numel() + 1, generator=gen, dtype=dtype,
                               device=dev)
            view = flat[1:].view(a.shape)
            check(view.data_ptr() % 16 != 0, "parity: view is aligned")
            slabs = [p for p in range(kfwht.ROWS_MAX_LOG_P + 1)
                     if kfwht.ROWS_LEAF << p <= n and kfwht.rows_smem(
                         p, n_rows, m, k, a.element_size())
                     <= kfwht.ROWS_MAX_SMEM]
            for what, aa, ss in (("+-1 signs", a, signs),
                                 ("signs other than +-1", a, odd),
                                 ("a view off a 16-byte boundary", view, odd)):
                want = ops.srht_apply_rows(aa, ss, rows, impl="ref")
                for log_p in slabs:
                    got = ksrht.srht_rows_kernel(aa, ss, rows, log_p=log_p)
                    err = _max_err(got, want)
                    worst = max(worst, err)
                    check(torch.equal(got, want),
                          f"srht_rows_kernel {dtype} A ({g}, {n_rows}, {m}) "
                          f"n={n} k={k} slabs of 16 * 2^{log_p} rows with "
                          f"{what}: differs from the plain version (max abs "
                          f"err {err:.3e})")
    return worst


# ---------------------------------------------------------------------------
# 4. quickstart
# ---------------------------------------------------------------------------

def _flens_run(problem, w0, w_star, rounds, *, impl=None, **kw):
    from repro_torch.core import FLeNS, run_rounds
    from repro_torch.kernels import ops

    with ops.use_impl(impl):
        opt = FLeNS(**kw)
        return opt, run_rounds(opt, problem, w0, w_star, rounds=rounds)


def _check_trajectory(hist, label: str) -> None:
    check(bool(torch.isfinite(torch.as_tensor(hist.loss)).all()),
          f"{label}: non-finite loss")
    check(bool((hist.loss[1:] <= hist.loss[:-1]).all()),
          f"{label}: the guarded loss rose")
    check(hist.gap[-1] < 0.1 * hist.gap[0],
          f"{label}: gap {hist.gap[0]:.3e} -> {hist.gap[-1]:.3e} did not "
          f"fall tenfold")


def phase_quickstart() -> dict:
    from repro_torch.core import logistic, make_problem, newton_solve
    from repro_torch.data import make_classification
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    X, y = make_classification(0, n=QUICK["n"], dim=QUICK["dim"], device=dev)
    problem = make_problem(X, y, m=QUICK["m"], lam=QUICK["lam"],
                           objective=logistic, device=dev)
    w0 = torch.zeros(QUICK["dim"], dtype=torch.float64, device=dev)
    w_star = newton_solve(problem, w0)
    rounds = 12
    ops.reset_launch_counts()
    _, hist = _flens_run(problem, w0, w_star, rounds, k=QUICK["k"])
    counts = ops.launch_counts()
    want = {"fwht": 0, "srht_apply": 3 * rounds, "srht_apply_t": 2 * rounds,
            **NO_ROWS, **NO_CODEC, **NO_LM}
    check(counts == want, f"quickstart launches {counts} != {want}")
    _check_trajectory(hist, "quickstart")
    _, plain = _flens_run(problem, w0, w_star, rounds, impl="ref",
                          k=QUICK["k"])
    check((hist.loss == plain.loss).all(),
          f"quickstart through the kernels {hist.loss.tolist()} != through "
          f"the plain versions {plain.loss.tolist()}")
    ops.reset_launch_counts()
    _, plus = _flens_run(problem, w0, w_star, rounds, k=QUICK["k"],
                         variant="plus")
    counts_plus = ops.launch_counts()
    check(counts_plus == {"fwht": 0, "srht_apply": 4 * rounds,
                          "srht_apply_t": 3 * rounds, **NO_ROWS, **NO_CODEC,
                          **NO_LM},
          f"FLeNS+ launches {counts_plus}")
    _check_trajectory(plus, "quickstart FLeNS+")
    log("[quickstart] gap " + " ".join(f"{g:.3e}" for g in hist.gap))
    log(f"[quickstart] launches {counts} (FLeNS+ {counts_plus}); "
        f"trajectory equal to the plain versions' on the card")
    return {"gap": hist.gap.tolist(), "launches": counts,
            "launches_plus": counts_plus, "gap_plus": plus.gap.tolist(),
            "bytes_per_round": float(hist.cumulative_bytes[1])}


# ---------------------------------------------------------------------------
# 5. full size
# ---------------------------------------------------------------------------

def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound_ms(read: int, written: int, ops_count: float, dtype,
              peak: float = None) -> tuple:
    t_bytes = (read + written) / MEM_BYTES_PER_S
    t_ops = ops_count / (peak or PEAK_OPS_PER_S[dtype])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


HOST_REPS = 10_000


def _host_us(fn, reps: int = HOST_REPS) -> float:
    """Host microseconds per call of fn over reps back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / reps / 1e3


def _host_path(y, signs, rows, dim, dense) -> dict:
    """Host microseconds per call of each step of the launch path of
    ``ops.srht_apply_t(..., impl="cuda")``, each step timed alone; beside
    them the same steps as the parent commit took them, and the host time
    of the library call."""
    import ctypes

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fwht as kfwht
    from repro_torch.kernels import srht as ksrht

    n, k = signs.shape[0], rows.shape[0]
    suffix = kfwht.check_input(y, "y")
    norm, scale = ksrht._factors(n, k, y.dtype)
    entry = ksrht._entry("srht_apply_t", suffix, False)
    out = y.new_empty(y.shape[:-1] + (dim,))
    nrows = y.numel() // k
    args = (y.data_ptr(), signs.data_ptr(), rows.data_ptr(), out.data_ptr(),
            nrows, dim, n, k, norm, scale, kfwht.stream_of(y))
    lib = _build.library()
    p, i = ctypes.c_void_p, ctypes.c_int
    by_ctypes = ctypes.CFUNCTYPE(
        ctypes.c_int, p, p, p, p, ctypes.c_longlong, i, i, i, ctypes.c_double,
        ctypes.c_double, p)((f"repro_srht_apply_t_{suffix}", lib))

    def guard():
        with kfwht.device_guard(y):
            pass

    def parent_guard():
        with torch.cuda.device(y.device):
            pass
    path = {
        "dispatch (resolve_impl, get_impl)":
            lambda: ops.get_impl("srht_apply_t", ops.resolve_impl("cuda", y), y),
        "checks (check_input, _check_operator)":
            lambda: (kfwht.check_input(y, "y"),
                     ksrht._check_operator(y, signs, rows, dim)),
        "output (new_empty)": lambda: y.new_empty(out.shape),
        "factors (_factors)": lambda: ksrht._factors(n, k, y.dtype),
        "entry point (_entry)":
            lambda: ksrht._entry("srht_apply_t", suffix, False),
        "device guard (device_guard)": guard,
        "stream (stream_of)": lambda: kfwht.stream_of(y),
        "launch (extension call)": lambda: entry(*args),
    }
    parent = {
        "capability (get_device_capability)":
            lambda: torch.cuda.get_device_capability(y.device),
        "operator checks by torch.device":
            lambda: (signs.dtype != y.dtype or signs.device != y.device,
                     rows.dtype != torch.int64 or rows.device != y.device),
        "output (torch.empty(device=))":
            lambda: torch.empty(out.shape, dtype=y.dtype, device=y.device),
        "device guard (torch.cuda.device)": parent_guard,
        "stream (current_stream().cuda_stream)":
            lambda: torch.cuda.current_stream(y.device).cuda_stream,
        "entry point (f-string getattr)":
            lambda: getattr(lib, f"repro_srht_apply_t_{suffix}"),
        "launch (ctypes call)": lambda: by_ctypes(*args),
    }
    steps = {name: _host_us(fn) for name, fn in path.items()}
    return {"steps_us": steps, "steps_sum_us": sum(steps.values()),
            "call_us": _host_us(lambda: ops.srht_apply_t(y, signs, rows, dim,
                                                         impl="cuda")),
            "parent_steps_us": {name: _host_us(fn)
                                for name, fn in parent.items()},
            "library_call_us": _host_us(lambda: torch.matmul(y, dense)),
            "reps": HOST_REPS}


def _srht_fwd_row(label, x, signs, rows, dense) -> dict:
    """srht_apply through the kernel at one shape: events and the
    profiler's device time, the bound, the plain version and the library
    yardstick x @ S.T (``dense`` is S, (k, dim); None where S is too large
    to hold)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fwht import kernel_route

    n, k = signs.shape[0], rows.shape[0]
    item = x.element_size()
    rows_n = x.numel() // x.shape[-1]
    reps = 20 if x.numel() > 1_000_000 else 200

    def kern():
        return ops.srht_apply(x, signs, rows, impl="cuda")

    def plain():
        return ops.srht_apply(x, signs, rows, impl="ref")

    def lib():
        return torch.matmul(x, dense.T)
    # x, signs and rows read once, the outputs written once; per row n
    # log2(n) adds, n sign flips, and x norm x scale on the k kept
    bound, bound_by = _bound_ms(
        x.numel() * item + n * item + k * 8, rows_n * k * item,
        rows_n * (n * int(math.log2(n)) + n + 2 * k), x.dtype)
    got, want = kern(), plain()
    check(torch.equal(got, want), f"srht_apply {label}: kernel differs from "
          f"the plain version (max abs err {_max_err(got, want):.3e})")
    by_kernel = _device_kernels_ms(kern, reps)
    return dict(shape=label, dims=list(x.shape), n=n, k=k,
                route=kernel_route("srht_apply", n), ms=_time_ms(kern, reps),
                device_ms=sum(by_kernel.values()), device_kernels_ms=by_kernel,
                plain_ms=_time_ms(plain, max(reps // 4, 5)),
                library_ms=None if dense is None else _time_ms(lib, reps),
                library_device_ms=None if dense is None else _device_ms(lib, reps),
                bound_ms=bound, bound_by=bound_by,
                max_abs_err=_max_err(got, want))


def _kernel_timings(s, a, gs) -> dict:
    """Each kernel at its main-path shapes, beside its bound, the plain
    version and one PyTorch call computing the same function, with the
    profiler's device time and the kernel that serves the shape; for
    srht_apply_t also the host path step by step."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.fwht import kernel_route

    dtype, dev = a.dtype, a.device
    item = a.element_size()
    n, k, dim = s.signs.shape[0], s.k, s.dim
    dense = s.dense()  # (k, dim), the library yardstick's operator
    eye_k = torch.eye(k, dtype=dtype, device=dev)
    delta = torch.randn(k, dtype=dtype, device=dev)
    # the quickstart's operator (dim 64 -> k 32, n 64) and its S^T calls
    gen = torch.Generator(device=dev).manual_seed(5)
    q_signs, q_rows = _operator(gen, 64, QUICK["k"], dtype, dev)
    q_dense = kref.srht_apply_t(torch.eye(QUICK["k"], dtype=dtype, device=dev),
                                q_signs, q_rows, QUICK["dim"])
    q_eye = torch.eye(QUICK["k"], dtype=dtype, device=dev)
    q_delta = torch.randn(QUICK["k"], dtype=dtype, device=dev)
    susy = (s.signs, s.rows, dim, dense)
    quick = (q_signs, q_rows, QUICK["dim"], q_dense)
    calls = {  # kernel -> its main-path inputs and operator
        "srht_apply": [
            ("A_j (m, n_shard, M)", a, susy),
            ("gradients (m, M)", gs, susy),
            ("S^T I_k (k, M)", s.apply_t(eye_k), susy),
        ],
        "srht_apply_t": [
            ("I_k (k, k)", eye_k, susy),
            ("delta_k (k,)", delta, susy),
            ("quickstart I_k (32, 32)", q_eye, quick),
            ("quickstart delta_k (32,)", q_delta, quick),
        ],
    }
    out = {"srht_apply": [_srht_fwd_row(label, x, signs, rows, op)
                          for label, x, (signs, rows, _, op)
                          in calls.pop("srht_apply")]}
    for name, shapes in calls.items():
        rows_out = []
        for label, x, (signs, rows, d, op) in shapes:
            n_op, k_op = signs.shape[0], rows.shape[0]
            log_n = int(math.log2(n_op))
            op_bytes = n_op * item + k_op * 8  # signs + rows, read once
            rows_n = x.numel() // x.shape[-1]

            def kern(x=x, signs=signs, rows=rows, d=d):
                return ops.srht_apply_t(x, signs, rows, d, impl="cuda")

            def plain(x=x, signs=signs, rows=rows, d=d):
                return ops.srht_apply_t(x, signs, rows, d, impl="ref")

            def lib(x=x, op=op):
                return torch.matmul(x, op)
            read, written = x.numel() * item, rows_n * d * item
            count = rows_n * (n_op * log_n + k_op + 2 * d)
            reps = 20 if x.numel() > 1_000_000 else 200
            bound, bound_by = _bound_ms(read + op_bytes, written, count, dtype)
            row = dict(
                shape=label, dims=list(x.shape), n=n_op,
                route=kernel_route(name, n_op), ms=_time_ms(kern, reps),
                plain_ms=_time_ms(plain, max(reps // 4, 5)),
                library_ms=_time_ms(lib, reps), bound_ms=bound,
                bound_by=bound_by,
                max_abs_err=_max_err(kern(), plain()))
            check(row["max_abs_err"] == 0.0, f"{name} {label}: kernel "
                  f"differs from the plain version (max abs err "
                  f"{row['max_abs_err']:.3e})")
            row.update(device_ms=_device_ms(kern, reps),
                       library_device_ms=_device_ms(lib, reps),
                       host_path=_host_path(x, signs, rows, d, op))
            rows_out.append(row)
        out[name] = rows_out
    # fwht is off the main path; it is timed at the padded rows of the
    # path's largest call, (m * n_shard, n), and at the single-pass limit
    out["fwht"] = []
    for label, shape, reps in (
            ("padded rows of A_j (m * n_shard, n)", (a.numel() // dim, n), 20),
            ("(64, 2^14), the single-pass limit", (64, 1 << 14), 200)):
        xp = torch.randn(shape, dtype=dtype, device=dev)
        had = kref.hadamard_matrix(shape[1], dtype, dev)
        log_x = int(math.log2(shape[1]))
        bound, bound_by = _bound_ms(xp.numel() * item, xp.numel() * item,
                                    shape[0] * (shape[1] * log_x + shape[1]),
                                    dtype)

        def kern(xp=xp):
            return ops.fwht(xp, normalize=True, impl="cuda")

        def lib(xp=xp, had=had):
            return torch.matmul(xp, had)
        out["fwht"].append(dict(
            shape=label, dims=list(xp.shape), n=shape[1],
            route=kernel_route("fwht", shape[1]), ms=_time_ms(kern, reps),
            device_ms=_device_ms(kern, reps),
            plain_ms=_time_ms(lambda xp=xp: ops.fwht(xp, normalize=True,
                                                     impl="ref"), 5),
            library_ms=_time_ms(lib, reps),
            library_device_ms=_device_ms(lib, reps),
            bound_ms=bound, bound_by=bound_by,
            max_abs_err=_max_err(kern(), ops.fwht(xp, normalize=True,
                                                  impl="ref"))))
        check(out["fwht"][-1]["max_abs_err"] == 0.0, f"fwht {label}: kernel "
              f"differs from the plain version (max abs err "
              f"{out['fwht'][-1]['max_abs_err']:.3e})")
        del xp, had
    return out


def _profile_rounds(opt, problem, state, keys, copies_of=None) -> dict:
    """Device time by kernel over a few bare rounds (torch.profiler), and
    the device's busy share of the window's wall time; with ``copies_of``
    (a numel), the copies (``aten::copy_``, ``clone``, ``contiguous``) of
    a tensor of that many values the rounds made."""
    keys = iter(keys)

    def step():
        nonlocal state
        state = opt.round(problem, state, next(keys))
    return _profile_steps(step, 3, copies_of)


def _profile_steps(step, rounds: int, copies_of=None) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=copies_of is not None) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted(
        ((e.key, e.self_device_time_total, e.count)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1])
    busy_us = sum(t for _, t, _ in kernels)
    out = {"rounds": rounds, "wall_us": wall_us, "device_busy_us": busy_us,
           "busy_share": busy_us / wall_us,
           "top": [{"kernel": name[:90], "us_per_round": t / rounds,
                    "launches_per_round": c / rounds}
                   for name, t, c in kernels[:12]]}
    if copies_of is not None:
        out["copies"] = [
            {"op": e.name, "shapes": e.input_shapes} for e in prof.events()
            if e.name in ("aten::copy_", "aten::clone", "aten::contiguous")
            and any(math.prod(sh) == copies_of for sh in e.input_shapes
                    if isinstance(sh, list) and sh)]
    return out


def phase_full_size() -> "tuple[dict, tuple]":
    """Returns the record and the (problem, w0, w_star) the transport
    phase runs on."""
    from repro_torch.core import (
        FLeNS,
        logistic,
        make_problem,
        newton_solve,
        run_rounds,
    )
    from repro_torch.core.base import root_key, split
    from repro_torch.data import make_classification
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    X, y = make_classification(
        1, n=SUSY["n"], dim=SUSY["dim"], spectrum_decay=SUSY["spectrum_decay"],
        label_noise=SUSY["label_noise"], device=dev)
    problem = make_problem(X, y, m=SUSY["m"], lam=SUSY["lam"],
                           objective=logistic, device=dev)
    del X, y
    w0 = torch.zeros(SUSY["dim"], dtype=torch.float64, device=dev)
    w_star = newton_solve(problem, w0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    grad_star = float(torch.linalg.vector_norm(problem.global_grad(w_star)))
    check(grad_star < 1e-10, f"newton_solve gradient norm {grad_star:.3e}")

    rounds = 10
    ops.reset_launch_counts()
    opt = FLeNS(k=SUSY["k"])
    hist = run_rounds(opt, problem, w0, w_star, rounds=rounds)
    counts = ops.launch_counts()
    want = {"fwht": 0, "srht_apply": 3 * rounds, "srht_apply_t": 2 * rounds,
            **NO_ROWS, **NO_CODEC, **NO_LM}
    check(counts == want, f"full-size launches {counts} != {want}")
    _check_trajectory(hist, "full size")

    # bare rounds, host clock around work that ends in a synchronize
    state = opt.init(problem, w0)
    keys = split(root_key(7, device=dev), rounds + 1)
    state = opt.round(problem, state, keys[0])  # warm
    torch.cuda.synchronize()
    round_ms = []
    for t in range(rounds):
        t1 = time.perf_counter()
        state = opt.round(problem, state, keys[t + 1])
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    profile = _profile_rounds(opt, problem, state,
                              split(root_key(8, device=dev), 3))

    s = opt.policy.materialize(keys[0], problem.dim, dtype=torch.float64,
                               device=dev)
    a = problem.local_hess_sqrt(state["w"])
    gs = problem.local_grad(state["w"])
    timings = _kernel_timings(s, a, gs)
    log("[full] gap " + " ".join(f"{g:.3e}" for g in hist.gap))
    log(f"[full] setup {setup_s:.2f} s; run_rounds {hist.wall_time_s * 1e3 / rounds:.2f} "
        f"ms/round with per-round eval; bare rounds "
        f"{sorted(round_ms)[len(round_ms) // 2]:.2f} ms median "
        f"({min(round_ms):.2f}..{max(round_ms):.2f}); peak memory "
        f"{peak / 2**30:.2f} GiB; launches {counts}")
    log(f"[full] profile: device busy {profile['busy_share']:.1%} of "
        f"{profile['wall_us'] / profile['rounds'] / 1e3:.2f} ms/round")
    for r in profile["top"]:
        log(f"[full]   {r['us_per_round']:9.1f} us/round x"
            f"{r['launches_per_round']:.0f}  {r['kernel']}")
    for name, rows in timings.items():
        for r in rows:
            device = (f", device {r['device_ms']:.4f} (library "
                      f"{r['library_device_ms']:.4f})" if "device_ms" in r
                      else "")
            log(f"[full] {name:<12} {r['shape']:<38} {r['ms']:.4f} ms"
                f"{device} (bound {r['bound_ms']:.4f} by {r['bound_by']}, "
                f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}); "
                f"{r['route']}")
            if "host_path" in r:
                hp = r["host_path"]
                log(f"[full]   host path, us per call over {hp['reps']}: "
                    f"whole call {hp['call_us']:.2f}, steps "
                    f"{hp['steps_sum_us']:.2f} in all, library call "
                    f"{hp['library_call_us']:.2f}")
                for step, us in hp["steps_us"].items():
                    log(f"[full]     {step:<40} {us:7.2f}")
                for step, us in hp["parent_steps_us"].items():
                    log(f"[full]     parent: {step:<32} {us:7.2f}")
    return ({"gap": hist.gap.tolist(), "loss": hist.loss.tolist(),
             "launches": counts, "rounds": rounds,
             "run_rounds_ms_per_round": hist.wall_time_s * 1e3 / rounds,
             "round_ms": round_ms, "setup_s": setup_s,
             "peak_memory_bytes": peak, "profile": profile,
             "bytes_per_round":
             float(hist.cumulative_bytes[1]), "kernels": timings},
            (problem, w0, w_star))


# ---------------------------------------------------------------------------
# 5b. covtype at full size
# ---------------------------------------------------------------------------

def phase_covtype() -> dict:
    """FLeNS on the covtype twin at the real row count, through the
    forward SRHT's register route (n = 64); then srht_apply at the
    main-path shapes of covtype, phishing and the quickstart and at one
    FedNS-like call."""
    from repro_torch.core import logistic, make_problem, newton_solve
    from repro_torch.core.base import root_key, split
    from repro_torch.data import make_classification
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref

    dev = torch.device("cuda", 0)
    dim, k = COVTYPE["dim"], COVTYPE["k"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    X, y = make_classification(
        3, n=COVTYPE["n"], dim=dim, spectrum_decay=COVTYPE["spectrum_decay"],
        label_noise=COVTYPE["label_noise"], device=dev)
    problem = make_problem(X, y, m=COVTYPE["m"], lam=COVTYPE["lam"],
                           objective=logistic, device=dev)
    del X, y
    w0 = torch.zeros(dim, dtype=torch.float64, device=dev)
    w_star = newton_solve(problem, w0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    grad_star = float(torch.linalg.vector_norm(problem.global_grad(w_star)))
    check(grad_star < 1e-10, f"covtype newton_solve gradient norm {grad_star:.3e}")

    rounds = 10
    ops.reset_launch_counts()
    opt, hist = _flens_run(problem, w0, w_star, rounds, k=k)
    counts = ops.launch_counts()
    want = {"fwht": 0, "srht_apply": 3 * rounds, "srht_apply_t": 2 * rounds,
            **NO_ROWS, **NO_CODEC, **NO_LM}
    check(counts == want, f"covtype launches {counts} != {want}")
    _check_trajectory(hist, "covtype")
    _, plain = _flens_run(problem, w0, w_star, rounds, impl="ref", k=k)
    check((hist.loss == plain.loss).all(),
          f"covtype through the kernels {hist.loss.tolist()} != through the "
          f"plain versions {plain.loss.tolist()}")

    # bare rounds, host clock around work that ends in a synchronize
    state = opt.init(problem, w0)
    keys = split(root_key(7, device=dev), rounds + 1)
    state = opt.round(problem, state, keys[0])  # warm
    torch.cuda.synchronize()
    round_ms = []
    for t in range(rounds):
        t1 = time.perf_counter()
        state = opt.round(problem, state, keys[t + 1])
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    profile = _profile_rounds(opt, problem, state,
                              split(root_key(8, device=dev), 3))

    s = opt.policy.materialize(keys[0], dim, dtype=torch.float64, device=dev)
    dense = s.dense()
    calls = [("covtype A_j (m, n_shard, M)", problem.local_hess_sqrt(state["w"]),
              s.signs, s.rows, dense),
             ("covtype gradients (m, M)", problem.local_grad(state["w"]),
              s.signs, s.rows, dense),
             ("covtype S^T I_k (k, M)",
              s.apply_t(torch.eye(k, dtype=torch.float64, device=dev)),
              s.signs, s.rows, dense)]
    del problem, state
    # phishing (n_shard = 277 of 11,055 rows over 40 clients), the
    # quickstart, and FedNS's data-axis sketch at the SUSY size (1000
    # clients x 18 features, 5000 rows a shard) with one shared operator
    gen = torch.Generator(device=dev).manual_seed(6)
    n_shard = -(-PHISHING["n"] // PHISHING["m"])
    for label, shape, n, kk in (
            ("phishing A_j (m, n_shard, M)", (PHISHING["m"], n_shard, 68), 128, 17),
            ("phishing gradients (m, M)", (PHISHING["m"], 68), 128, 17),
            ("phishing S^T I_k (k, M)", (17, 68), 128, 17),
            ("quickstart A_j (m, n_shard, M)", (8, 500, 64), 64, QUICK["k"]),
            ("FedNS data axis (m * M, n_shard), one operator", (18000, 5000),
             8192, 10)):
        signs, rows = _operator(gen, n, kk, torch.float64, dev)
        x = torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
        eye = torch.eye(shape[-1], dtype=torch.float64, device=dev)
        calls.append((label, x, signs, rows, kref.srht_apply(eye, signs, rows).T))
        del eye
    timings = []
    for label, x, signs, rows, op in calls:
        timings.append(_srht_fwd_row(label, x, signs, rows, op))
    del calls
    log("[covtype] gap " + " ".join(f"{g:.3e}" for g in hist.gap))
    log(f"[covtype] setup {setup_s:.2f} s; run_rounds "
        f"{hist.wall_time_s * 1e3 / rounds:.2f} ms/round with per-round eval; "
        f"bare rounds {sorted(round_ms)[len(round_ms) // 2]:.2f} ms median "
        f"({min(round_ms):.2f}..{max(round_ms):.2f}); peak memory "
        f"{peak / 2**30:.2f} GiB; launches {counts}; trajectory equal to the "
        f"plain versions' on the card")
    log(f"[covtype] profile: device busy {profile['busy_share']:.1%} of "
        f"{profile['wall_us'] / profile['rounds'] / 1e3:.2f} ms/round")
    for r in profile["top"]:
        log(f"[covtype]   {r['us_per_round']:9.1f} us/round x"
            f"{r['launches_per_round']:.0f}  {r['kernel']}")
    for r in timings:
        log(f"[covtype] srht_apply {r['shape']:<46} {r['ms']:.4f} ms, device "
            f"{r['device_ms']:.4f} (bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}, plain {r['plain_ms']:.4f}, x @ S.T "
            f"{r['library_ms']:.4f}, device {r['library_device_ms']:.4f}); "
            f"{r['route']}")
    return {"gap": hist.gap.tolist(), "loss": hist.loss.tolist(),
            "launches": counts, "rounds": rounds,
            "run_rounds_ms_per_round": hist.wall_time_s * 1e3 / rounds,
            "round_ms": round_ms, "setup_s": setup_s,
            "peak_memory_bytes": peak, "profile": profile,
            "srht_apply": timings}


# ---------------------------------------------------------------------------
# 5c. the other Table-I optimizers at full size
# ---------------------------------------------------------------------------

def _dense_operators(signs: torch.Tensor, rows: torch.Tensor,
                     dim: int) -> torch.Tensor:
    """The m SRHT operators as dense (m, k, dim) matrices, the library
    yardstick's operands: S_j[c, i] = signs_j[i] (-1)^popcount(rows_j[c]
    & i) / sqrt(k)."""
    k = rows.shape[1]
    both = rows[:, :, None] & torch.arange(dim, device=rows.device)
    parity = torch.zeros_like(both)
    for b in range(int(signs.shape[1]).bit_length()):
        parity ^= (both >> b) & 1
    return ((1 - 2 * parity).to(signs.dtype) * signs[:, None, :dim]
            / math.sqrt(k))


def _srht_batched_row(label, a, k, seed) -> dict:
    """FedNS's call: srht_apply_rows of A (m, n_shard, M), one operator a
    client, which must take srht_rows_kernel (A read in place). Beside it,
    in turns in this call: the parent's way (A's contiguous transpose,
    then the batched srht_apply kernel; the copy alone too), torch.bmm of
    the dense per-client S_j with A_j (the build not timed), the plain
    version and the bound. Events, and the profiler's device time by
    kernel, which must find srht_rows_kernel."""
    from repro_torch.core.sketch import make_sketches
    from repro_torch.keys import key_from_ints
    from repro_torch.kernels import ops
    from repro_torch.kernels import srht as ksrht
    from repro_torch.kernels.fwht import ROWS_LEAF, kernel_route, rows_route

    m, n_shard, dim_f = a.shape
    s = make_sketches(key_from_ints(seed), "srht", m, k, n_shard,
                      dtype=a.dtype, device=a.device)
    n = s.signs.shape[1]
    route = rows_route(n, n_shard, dim_f, k, a.element_size())
    check(route == "srht_rows_kernel", f"srht_apply_rows {label}: routed "
          f"to {route}, not to srht_rows_kernel")
    dense = _dense_operators(s.signs, s.rows, n_shard)
    item = a.element_size()
    reps = 20 if a.numel() > 1_000_000 else 200

    def kern():
        return ops.srht_apply_rows(a, s.signs, s.rows, impl="cuda")

    def parent():
        return ksrht.srht_apply_cuda(a.transpose(1, 2).contiguous(), s.signs,
                                     s.rows).transpose(1, 2)

    def copy():
        return a.transpose(1, 2).contiguous()

    def plain():
        return ops.srht_apply_rows(a, s.signs, s.rows, impl="ref")

    def lib():
        return torch.bmm(dense, a)
    before = ops.launch_counts()
    got = kern()
    after = ops.launch_counts()
    check(after["srht_apply"] - before["srht_apply"] == 1
          and after["srht_apply_rows"] - before["srht_apply_rows"] == 1,
          f"srht_apply_rows {label}: not one srht_rows_kernel launch")
    want = plain()
    check(torch.equal(got, want), f"srht_apply_rows {label}: kernel differs "
          f"from the plain version (max abs err {_max_err(got, want):.3e})")
    check(torch.equal(parent(), want), f"srht_apply_rows {label}: the "
          f"parent's way differs from the plain version")
    lib_err = _max_err(got, lib())
    check(lib_err < 1e-9 * float(got.abs().max()),
          f"srht_apply_rows {label}: bmm yardstick off by {lib_err:.3e}")
    # A, the signs of A's n_shard rows and the kept rows of the m
    # operators read once, the outputs written once; the operations: a
    # sign and 4 stages a value of each 16-row leaf, then k (leaves - 1)
    # sums and x norm x scale a column
    leaves = -(-n_shard // ROWS_LEAF)
    bound, bound_by = _bound_ms(
        (a.numel() + m * n_shard) * item + m * k * 8, m * k * dim_f * item,
        m * dim_f * (leaves * ROWS_LEAF * 5 + k * (leaves - 1) + 2 * k),
        a.dtype)
    turns = {"kernel": [], "parent": []}
    for name in ("kernel", "parent", "parent", "kernel"):
        turns[name].append(_time_ms(kern if name == "kernel" else parent, reps))
    by_kernel = _device_kernels_ms(kern, reps)
    check(any("srht_rows_kernel" in name for name in by_kernel),
          f"srht_apply_rows {label}: the profiler found no {route} launch "
          f"(device kernels {sorted(by_kernel)})")
    parent_by_kernel = _device_kernels_ms(parent, reps)
    row = dict(shape=label, dims=list(a.shape), operators=m, n=n, k=k,
               route=route + ", A (m, n_shard, M) as it lies",
               ms=sum(turns["kernel"]) / 2, ms_turns=turns["kernel"],
               device_ms=sum(by_kernel.values()), device_kernels_ms=by_kernel,
               transpose_ms=_time_ms(copy, reps),
               transpose_device_ms=_device_ms(copy, reps),
               plain_ms=_time_ms(plain, max(reps // 4, 5)),
               library="torch.bmm(S (m, k, n_shard), A (m, n_shard, M))",
               library_ms=_time_ms(lib, reps),
               library_device_ms=_device_ms(lib, reps),
               library_max_abs_err=lib_err, bound_ms=bound, bound_by=bound_by,
               max_abs_err=_max_err(got, want))
    # the parent's route (the copy, then the batched forward kernel) as a
    # route of srht_apply, timed in turns with the kernel above
    row["parent"] = dict(
        shape=label, dims=[m, dim_f, n_shard],
        route="transpose copy + " + kernel_route("srht_apply", n)
        + ", one operator a client (the parent's route)",
        ms=sum(turns["parent"]) / 2, ms_turns=turns["parent"],
        device_ms=sum(parent_by_kernel.values()),
        device_kernels_ms=parent_by_kernel, plain_ms=row["plain_ms"],
        library_ms=row["library_ms"])
    row["parent"]["bound_ms"], row["parent"]["bound_by"] = _bound_ms(
        (a.numel() + m * n_shard) * item + m * k * 8, m * k * dim_f * item,
        m * dim_f * (n * int(math.log2(n)) + n + 2 * k), a.dtype)
    del dense, got, want
    return row


def _fedns_transport(rounds: int = 12) -> dict:
    """FedNS with a fixed basis (EF-eligible) at the quickstart size under
    one CommConfig on the edge channel: the kernels' trajectory, bytes and
    traces equal to the plain versions'; launches as the round implies."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import FedNS, logistic, make_problem, newton_solve
    from repro_torch.core import run_rounds
    from repro_torch.data import make_classification
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    X, y = make_classification(0, n=QUICK["n"], dim=QUICK["dim"], device=dev)
    problem = make_problem(X, y, m=QUICK["m"], lam=QUICK["lam"],
                           objective=logistic, device=dev)
    w0 = torch.zeros(QUICK["dim"], dtype=torch.float64, device=dev)
    w_star = newton_solve(problem, w0)
    # every client scheduled (a half cohort's Hessian diverges here at
    # mu = 1); the edge channel still drops 10%
    cfg = CommConfig(codecs={"sa": "qint8", "grad": "topk0.5+qint8"},
                     channel=_edge_channel(QUICK["m"]), scheduler="full",
                     error_feedback=True, seed=1)
    runs = {}
    for impl in (None, "ref"):
        ops.reset_launch_counts()
        with ops.use_impl(impl):
            # a basis held across rounds needs k = M here to converge
            runs[impl] = run_rounds(FedNS(k=QUICK["dim"], sketch="srht:fixed"),
                                    problem, w0, w_star, rounds=rounds,
                                    comm=cfg)
        if impl is None:
            counts = ops.launch_counts()
    hist, plain = runs[None], runs["ref"]
    per_round = _codec_launches_per_round(cfg, ("grad", "sa"))
    want = {"fwht": 0, "srht_apply": rounds, "srht_apply_t": 0, **NO_LM,
            "srht_apply_rows": rounds,
            **{op: c * rounds for op, c in per_round.items()}}
    check(counts == want, f"FedNS under transport launches {counts} != {want}")
    check((hist.loss == plain.loss).all(),
          f"FedNS under transport: kernels {hist.loss.tolist()} != plain "
          f"{plain.loss.tolist()}")
    check((hist.cumulative_bytes == plain.cumulative_bytes).all()
          and [t.to_dict() for t in hist.traces]
          == [t.to_dict() for t in plain.traces],
          "FedNS under transport: bytes or traces differ from the plain run")
    check(set(hist.ef_residuals) == {"sa", "grad"},
          f"FedNS srht:fixed EF payloads {sorted(hist.ef_residuals)}")
    check(bool(torch.isfinite(torch.as_tensor(hist.loss)).all())
          and hist.gap[-1] < hist.gap[0],
          f"FedNS under transport: gap {hist.gap.tolist()}")
    log(f"[table-I] FedNS srht:fixed, k 64, at the quickstart size under "
        f"{{sa: qint8, grad: topk0.5+qint8}}, full cohort, EF: gap "
        + " ".join(f"{g:.2e}" for g in hist.gap[::3])
        + f"; {hist.cumulative_bytes[-1]:.0f} bytes, launches {counts}; "
        f"trajectory, bytes and traces equal to the plain versions'")
    return {"gap": hist.gap.tolist(), "launches": counts,
            "cumulative_bytes": hist.cumulative_bytes.tolist(),
            "ef_residuals": hist.ef_residuals}


def phase_table_one(problem, w0, w_star) -> dict:
    """The nine other Table-I optimizers on the SUSY problem at full size,
    10 rounds each with comm=None; FedNS and FedNDES one batched
    srht_apply launch a round and their trajectories equal to the plain
    versions' on the card; then the batched srht_apply timed at the three
    FedNS shapes, and FedNS under a transport at the quickstart size."""
    from repro_torch.core import make_optimizer, run_rounds
    from repro_torch.core.base import root_key, split
    from repro_torch.kernels import ops

    dev = problem.X.device
    rounds = 10
    out = {}
    for name, kw in TABLE_ONE:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        opt = make_optimizer(name, **kw)
        hist = run_rounds(opt, problem, w0, w_star, rounds=rounds)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        want = {"fwht": 0, "srht_apply": rounds if name in SKETCHED else 0,
                "srht_apply_t": 0, **NO_CODEC, **NO_LM,
                "srht_apply_rows": rounds if name in SKETCHED else 0}
        check(counts == want, f"{name} launches {counts} != {want}")
        check(bool(torch.isfinite(torch.as_tensor(hist.loss)).all()),
              f"{name}: non-finite loss {hist.loss.tolist()}")
        check(hist.gap[-1] < hist.gap[0],
              f"{name}: gap {hist.gap[0]:.3e} -> {hist.gap[-1]:.3e} did not fall")
        if name in SKETCHED:
            with ops.use_impl("ref"):
                plain = run_rounds(make_optimizer(name, **kw), problem, w0,
                                   w_star, rounds=rounds)
            check((hist.loss == plain.loss).all(),
                  f"{name} through the kernel {hist.loss.tolist()} != through "
                  f"the plain version {plain.loss.tolist()}")
        state = opt.init(problem, w0)
        keys = iter(split(root_key(7, device=dev), rounds + 1))

        def step():
            nonlocal state
            state = opt.round(problem, state, next(keys))
        bare = _bare_ms(step, rounds)
        row = {"gap": hist.gap.tolist(), "loss": hist.loss.tolist(),
               "launches": counts, "uplink_floats": hist.uplink_floats,
               "run_rounds_ms_per_round": hist.wall_time_s * 1e3 / rounds,
               "round_ms": bare, "peak_memory_bytes": peak}
        if name in SKETCHED:
            row["k"] = opt.k
            # the clients' A (m, n_shard, M): no copy of it in a round
            row["profile"] = _profile_rounds(opt, problem, state,
                                             split(root_key(8, device=dev), 3),
                                             copies_of=problem.X.numel())
            check(not row["profile"]["copies"], f"{name}: the profiled "
                  f"rounds copied A: {row['profile']['copies'][:4]}")
        out[name] = row
        log(f"[table-I] {name:<18} gap " + " ".join(f"{g:.2e}" for g in hist.gap))
        log(f"[table-I] {name:<18} run_rounds "
            f"{row['run_rounds_ms_per_round']:.2f} ms/round with per-round "
            f"eval; bare rounds {sorted(bare)[len(bare) // 2]:.2f} ms median "
            f"({min(bare):.2f}..{max(bare):.2f}); peak memory "
            f"{peak / 2**30:.2f} GiB; uplink {hist.uplink_floats} floats"
            + (f"; k {opt.k}; srht_apply launches {counts['srht_apply']} "
               f"(srht_rows_kernel {counts['srht_apply_rows']}), "
               f"trajectory equal to the plain version's"
               if name in SKETCHED else ""))
        if name in SKETCHED:
            prof = row["profile"]
            log(f"[table-I]   profile: device busy {prof['busy_share']:.1%} "
                f"of {prof['wall_us'] / prof['rounds'] / 1e3:.2f} ms/round; "
                f"copies of A's {problem.X.numel():,} values: "
                f"{len(prof['copies'])}")
            for r in prof["top"][:8]:
                log(f"[table-I]   {r['us_per_round']:9.1f} us/round x"
                    f"{r['launches_per_round']:.0f}  {r['kernel']}")
    # srht_apply_rows at the three FedNS shapes: SUSY's A_j (at w*),
    # covtype's and the quickstart's (random A of their shapes)
    gen = torch.Generator(device=dev).manual_seed(12)
    timings = [_srht_batched_row("SUSY A_j (1000, 5000, 18) -> n 8192, k 10",
                                 problem.local_hess_sqrt(w_star), SUSY["k"], 1)]
    for label, shape, k in (
            ("covtype A_j (200, 2906, 54) -> n 4096, k 20", (200, 2906, 54),
             COVTYPE["k"]),
            ("quickstart A_j (8, 500, 64) -> n 512, k 32", (8, 500, 64),
             QUICK["k"])):
        a = torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
        timings.append(_srht_batched_row(label, a, k, 2))
        del a
    for r in timings:
        par = r["parent"]
        log(f"[table-I] srht_apply_rows {r['shape']}: {r['ms']:.4f} ms "
            f"({' / '.join(f'{t:.4f}' for t in r['ms_turns'])}), device "
            f"{r['device_ms']:.4f} (bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}, plain {r['plain_ms']:.4f}, bmm "
            f"{r['library_ms']:.4f}, device {r['library_device_ms']:.4f}); "
            f"{r['route']}")
        log(f"[table-I]   the parent's way, in turns with it: "
            f"{par['ms']:.4f} ms ({' / '.join(f'{t:.4f}' for t in par['ms_turns'])}), "
            f"device {par['device_ms']:.4f}; the transpose copy A -> (m, M, "
            f"n_shard) alone {r['transpose_ms']:.4f}, device "
            f"{r['transpose_device_ms']:.4f}")
        for name, ms in {**r["device_kernels_ms"],
                         **{f"(parent) {k}": v for k, v
                            in par["device_kernels_ms"].items()}}.items():
            log(f"[table-I]   {ms:.4f} ms  {name}")
    return {"optimizers": out, "srht_apply_rows": timings,
            "fedns_transport": _fedns_transport()}


# ---------------------------------------------------------------------------
# 5d. the asynchronous driver at SUSY's full size
# ---------------------------------------------------------------------------

# benchmarks/paper_common.py:16-31, straggler_edge_channel: log-spaced
# uplinks 3e4-3e6 B/s, 10x downlinks, 50 ms latency, 30% stragglers at
# 10x, no dropout (the full-quorum anchor stays on the lock-step path)
STRAGGLER = dict(lo=3e4, hi=3e6, down=10.0, latency_s=0.05,
                 straggler_prob=0.30, straggler_slowdown=10.0)
# examples/edge_clients.py:94-105, population_edge_channel: per-id links
POP_EDGE = dict(uplink_bytes_per_s="loguniform:3e4,3e6",
                downlink_bytes_per_s="loguniform:3e5,3e7", latency_s=0.08,
                straggler_prob=0.20, straggler_slowdown=10.0,
                dropout_prob=0.10)
FLENS_PLUS_UPLINKS = ("h_sk", "sg", "grad", "loss")
# the event loop's host work: these session methods, timed apart from
# the rounds (the device work) they surround
EVENT_METHODS = ("begin_round", "end_round", "_pump", "_dispatch_cohort",
                 "_record_trace",
                 "_gc_snapshots", "_groups", "_combine", "_mask")


def _card() -> torch.device:
    return torch.device("cuda", 0)


def _straggler_channel(m: int):
    from repro_torch.comm import ChannelModel

    c = STRAGGLER
    rates = torch.logspace(math.log10(c["lo"]), math.log10(c["hi"]), m,
                           dtype=torch.float64).numpy()
    return ChannelModel(uplink_bytes_per_s=rates,
                        downlink_bytes_per_s=c["down"] * rates,
                        latency_s=c["latency_s"],
                        straggler_prob=c["straggler_prob"],
                        straggler_slowdown=c["straggler_slowdown"])


def _groups_per_commit(hist) -> list:
    """Distinct base versions among each commit's arrivals."""
    return [len(np.unique(tr.staleness[~np.isnan(tr.staleness)]))
            for tr in hist.traces]


def _expected_launches(cfg, executed: int) -> dict:
    """FLeNS+ launches 4 srht_apply and 3 srht_apply_t a round, and each
    codec stage one kernel a round."""
    per_round = _codec_launches_per_round(cfg, FLENS_PLUS_UPLINKS)
    return {"fwht": 0, "srht_apply": 4 * executed,
            "srht_apply_t": 3 * executed, **NO_ROWS, **NO_LM,
            **{op: n * executed for op, n in per_round.items()}}


def _timed_events(session) -> dict:
    """Wrap the session's event-loop methods with host timers (an outer
    call's time includes the calls it makes, counted once)."""
    acc = {"s": 0.0, "depth": 0}
    for name in EVENT_METHODS:
        fn = getattr(session, name, None)
        if fn is None:
            continue

        def timed(*a, _fn=fn, **k):
            acc["depth"] += 1
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                acc["depth"] -= 1
                if acc["depth"] == 0:
                    acc["s"] += time.perf_counter() - t0
        setattr(session, name, timed)
    return acc


def _bare_commits(opt, problem, w0, cfg, commits: int,
                  population=None, profiled: bool = True) -> dict:
    """Drive ``commits`` steps of the session ``cfg`` selects, each ended
    by a synchronize: ms a step, the event loop's host ms a step apart
    from the rounds, and (``profiled``) a profile of one more step
    (device busy share)."""
    from repro_torch.comm import make_session
    from repro_torch.core.base import build_round, root_key, split

    dev = w0.device
    init_on = problem if population is None else population.eval_problem()
    weights = (None if population is not None
               else problem.client_weights.cpu().numpy())
    session = make_session(
        cfg, m=init_on.m if population is None else population.m,
        keys=split(root_key(11, device=dev), commits + 1),
        state0=opt.init(init_on, w0), mask_dtype=w0.dtype, device=dev,
        population=population, client_weights=weights)
    fn = build_round(opt, problem, session, population=population)
    session.prepare(fn)
    session.begin_variant(None)
    torch.cuda.synchronize()
    events = _timed_events(session)
    ms = []
    for _ in range(commits):
        t0 = time.perf_counter()
        session.step(fn)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    host_ms = events["s"] * 1e3 / commits
    profile = (_profile_steps(lambda: session.step(fn), 1) if profiled
               else None)
    store = getattr(session, "ef_store", None)
    return {"ms": ms, "median_ms": sorted(ms)[len(ms) // 2],
            "event_host_ms": host_ms, "profile": profile,
            "ef_store_bytes": store.nbytes if store is not None else None}


def _async_runs(problem, w0, w_star, runs, make_opt, label: str,
                population=None) -> dict:
    """Each run: run_rounds through the kernels (launches counted and
    checked), again through the plain versions (traces equal, losses
    bit-equal), then bare steps timed and profiled."""
    from repro_torch.comm import summarize
    from repro_torch.core import run_rounds
    from repro_torch.kernels import ops

    out = {}
    for name, rounds, cfg in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        hist = run_rounds(make_opt(), problem if population is None
                          else population, w0, w_star, rounds=rounds,
                          comm=cfg)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        groups = (_groups_per_commit(hist) if cfg.async_mode
                  else [1] * rounds)
        executed = sum(groups) + (1 if cfg.async_mode else 0)  # + the probe
        want = _expected_launches(cfg, executed)
        check(counts == want, f"{label} {name}: launches {counts} != {want}")
        check(bool(np.isfinite(hist.loss).all()),
              f"{label} {name}: non-finite loss {hist.loss.tolist()}")
        check(hist.loss[-1] < hist.loss[0],
              f"{label} {name}: the loss did not fall {hist.loss.tolist()}")
        with ops.use_impl("ref"):
            plain = run_rounds(make_opt(), problem if population is None
                               else population, w0, w_star, rounds=rounds,
                               comm=cfg)
        check((hist.loss == plain.loss).all()
              and [t.to_dict() for t in hist.traces]
              == [t.to_dict() for t in plain.traces],
              f"{label} {name}: the run through the kernels "
              f"({hist.loss.tolist()}) differs from the plain versions' "
              f"({plain.loss.tolist()})")
        bare = _bare_commits(make_opt(), problem, w0, cfg, min(rounds, 20),
                             population)
        stale = (float(np.mean(hist.staleness)) if hist.staleness is not None
                 else 0.0)
        row = {"commits": rounds, "async": cfg.async_mode,
               "loss": hist.loss.tolist(), "gap": hist.gap.tolist(),
               "sim_time_s": float(hist.sim_time_s[-1]),
               "mean_staleness": stale, "groups_per_commit": groups,
               "rounds_executed": executed, "launches": counts,
               "launches_per_commit": {k: v / rounds for k, v in counts.items()
                                       if v},
               "run_rounds_ms_per_commit": hist.wall_time_s * 1e3 / rounds,
               "peak_memory_bytes": peak,
               "cumulative_bytes": float(hist.cumulative_bytes[-1]),
               "stats": summarize(hist.traces), "bare": bare}
        out[name] = row
        ms = bare["ms"]
        log(f"[{label}] {name}: {rounds} {'commits' if cfg.async_mode else 'rounds'}, "
            f"gap {hist.gap[0]:.3e} -> {hist.gap[-1]:.3e}; sim {row['sim_time_s']:.2f} s, "
            f"mean staleness {stale:.3f}, groups a commit "
            f"{np.mean(groups):.2f} (max {max(groups)}); launches {counts}")
        log(f"[{label}] {name}: bare {bare['median_ms']:.2f} ms a "
            f"{'commit' if cfg.async_mode else 'round'} median "
            f"({min(ms):.2f}..{max(ms):.2f}), event loop host "
            f"{bare['event_host_ms']:.3f} ms; profiled step busy "
            f"{bare['profile']['busy_share']:.1%} of "
            f"{bare['profile']['wall_us'] / 1e3:.2f} ms; run_rounds "
            f"{row['run_rounds_ms_per_commit']:.2f} ms with eval; peak "
            f"{peak / 2**30:.3f} GiB; trajectory equal to the plain versions'")
    return out


def phase_async(problem, w0, w_star) -> dict:
    """FLeNS+ at SUSY's full size under the asynchronous driver: the
    lock-step anchor, the three-driver race and the codec path."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import make_optimizer, run_rounds

    chan = _straggler_channel(problem.m)

    def flens_plus():
        return make_optimizer("flens_plus", k=SUSY["k"])

    # 1. the anchor: full-quorum async == sync, losses and bytes bit-equal
    sync = run_rounds(flens_plus(), problem, w0, w_star, rounds=3,
                      comm=CommConfig(channel=chan, seed=1))
    asy = run_rounds(flens_plus(), problem, w0, w_star, rounds=3,
                     comm=CommConfig(channel=chan, seed=1, async_mode=True))
    check(bool((sync.loss == asy.loss).all()
               and (sync.cumulative_bytes == asy.cumulative_bytes).all()),
          f"async anchor: sync {sync.loss.tolist()} != full-quorum async "
          f"{asy.loss.tolist()}")
    log(f"[async] anchor: 3 rounds sync == full-quorum async, losses and "
        f"bytes bit-equal ({asy.cumulative_bytes[-1]:.0f} B)")
    # 2. paper_common.sync_async_race (K = m / 4), 3. the codec path
    sketch, codecs, _ = TRANSPORTS["comp+sched+ef"]
    buf = max(2, problem.m // 4)
    runs = [("sync", 10, CommConfig(channel=chan, seed=1)),
            ("async_buf", 40, CommConfig(channel=chan, seed=1,
                                         async_mode=True, buffer_size=buf,
                                         staleness="inverse")),
            ("async_q50", 30, CommConfig(channel=chan, seed=1,
                                         async_mode=True, async_quantile=0.5,
                                         staleness="inverse")),
            ("async_buf comp+sched+ef", 20,
             CommConfig(channel=chan, seed=1, async_mode=True,
                        buffer_size=buf, staleness="inverse", codecs=codecs,
                        scheduler="bandwidth:0.5", error_feedback=True))]
    out = _async_runs(problem, w0, w_star, runs, flens_plus, "async")
    check(out["async_buf"]["sim_time_s"] < out["sync"]["sim_time_s"],
          "async: the buffered driver's clock did not run ahead of sync's")
    return {"anchor_loss": asy.loss.tolist(), "runs": out}


# ---------------------------------------------------------------------------
# 5e. client populations
# ---------------------------------------------------------------------------

# budgets the runs must stay within: a cohort-bounded run holds a few
# cohorts; materializing the population would hold its (m, n_shard, M)
# features, 100,000 x 64 x 16 x 8 B = 781 MiB at m = 100,000, and the
# SUSY rows again (687 MiB) over 5,000,000 rows
POP_BUDGET_MIB = {"synthetic": {"host": 256, "device": 256},
                  "dataset": {"host": 512, "device_over_rows": 512}}


class _HostRss:
    """The process's resident set, its high-water mark since ``start``:
    the kernel's own VmHWM where /proc/self/status has it, else the
    largest of VmRSS samples taken every 5 ms by a thread (``source``
    says which)."""

    def __init__(self):
        import threading

        self.source = ("VmHWM" if self._field("VmHWM") is not None
                       else "VmRSS sampled every 5 ms")
        self._peak = self.now()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()

    @staticmethod
    def _field(name: str) -> "float | None":
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(name + ":"):
                    return int(line.split()[1]) / 1024
        return None

    def now(self) -> float:
        rss = self._field("VmRSS")
        if rss is None:
            with open("/proc/self/statm") as f:
                rss = int(f.read().split()[1]) * 4096 / 2**20
        if not rss:  # no resident size reported: the rusage high-water
            import resource

            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        return rss

    def _sample(self) -> None:
        while not self._stop.wait(0.005):
            self._peak = max(self._peak, self.now())

    def high_water(self) -> float:
        hwm = self._field("VmHWM")
        return hwm if hwm is not None else max(self._peak, self.now())

    def close(self) -> None:
        self._stop.set()
        self._thread.join()


def _materialize_ms(pop, cohort: int) -> float:
    ids = np.sort(np.random.default_rng(0).choice(pop.m, cohort,
                                                  replace=False))
    pop.materialize(ids)
    torch.cuda.synchronize()
    ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        pop.materialize(ids)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sorted(ms)[len(ms) // 2]


def population_child() -> int:
    """The two population runs of phase 5e in a process of their own, so
    the host's RSS high-water mark (VmHWM) is theirs; prints one JSON
    line ``[populations] {...}``."""
    from repro_torch.comm import ChannelModel, CommConfig
    from repro_torch.core import (
        DatasetPopulation,
        SyntheticPopulation,
        logistic,
        make_optimizer,
        newton_solve,
    )
    from repro_torch.data import make_classification
    from repro_torch.kernels import _build

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    dev = _card()
    _build.module()
    _build.module("codec")
    torch.zeros(1, device=dev)
    rss = _HostRss()

    # 1. examples/edge_clients.py's population row, EF on
    codecs = TRANSPORTS["comp+sched+ef"][1]
    w0 = torch.zeros(16, dtype=torch.float64, device=dev)

    def configs(q: float, rounds: int):
        base = dict(codecs=codecs, channel=ChannelModel(**POP_EDGE),
                    scheduler=f"uniform:{q}", seed=1, error_feedback=True)
        return [("sync", rounds, CommConfig(**base)),
                ("async_buf", rounds, CommConfig(
                    async_mode=True, buffer_size=50, staleness="inverse",
                    **base))]

    # the same runs on a population of 2000 (the same cohort of 100)
    # first: what the libraries they load (cuBLAS, cuSOLVER, the
    # profiler's) and their transients take is not the population's
    warm = SyntheticPopulation(m=2000, dim=16, seed=1, dirichlet_alpha=0.3,
                               device=dev)
    _async_runs(None, w0, newton_solve(warm.eval_problem(), w0),
                configs(0.05, 10), lambda: make_optimizer("flens_plus", k=8),
                "populations warm-up m=2000", population=warm)
    del warm
    torch.cuda.synchronize()
    base_hwm = rss.high_water()
    out = {"baseline_host_rss_mib": base_hwm, "rss_source": rss.source}
    pop = SyntheticPopulation(m=100_000, dim=16, seed=1, dirichlet_alpha=0.3,
                              device=dev)
    w_star = newton_solve(pop.eval_problem(), w0)
    runs = configs(1e-3, 20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    syn = _async_runs(None, w0, w_star, runs,
                      lambda: make_optimizer("flens_plus", k=8),
                      "populations m=100000", population=pop)
    hwm = rss.high_water()
    dev_peak = max(r["peak_memory_bytes"] for r in syn.values()) / 2**20
    budget = POP_BUDGET_MIB["synthetic"]
    check(hwm - base_hwm < budget["host"],
          f"m=100000: host RSS high-water grew {hwm - base_hwm:.0f} MiB "
          f"(budget {budget['host']})")
    check(dev_peak < budget["device"],
          f"m=100000: device peak {dev_peak:.1f} MiB (budget "
          f"{budget['device']})")
    out["synthetic"] = {"runs": syn, "host_rss_high_water_mib": hwm,
                        "host_growth_mib": hwm - base_hwm,
                        "device_peak_mib": dev_peak,
                        "materialize_ms": _materialize_ms(pop, 100),
                        "cohort": 100, "budget_mib": budget}
    log(f"[populations] m=100000: host RSS high-water ({rss.source}) "
        f"{hwm:.0f} MiB ({hwm - base_hwm:.0f} over the {base_hwm:.0f} MiB "
        f"high-water of the same runs at m = 2000; budget "
        f"{budget['host']}), device peak {dev_peak:.1f} MiB "
        f"(budget {budget['device']}); materialize a cohort of 100 "
        f"{out['synthetic']['materialize_ms']:.3f} ms; EF store "
        f"{syn['sync']['bare']['ef_store_bytes']} B")
    # 5f's population drivers: the same population at q = 1e-3, sync 10
    # rounds and async 10 commits, with telemetry off and on
    out["telemetry"] = _telemetry_runs(
        None, w0, w_star,
        [(name, rounds, cfg, lambda: make_optimizer("flens_plus", k=8), 0)
         for name, rounds, cfg in configs(1e-3, 10)],
        "m=100000", population=pop)
    out["dynamics"] = _population_dynamics(pop, w0, w_star, 1e-3)
    del pop

    # 2. the SUSY twin at its 5,000,000 rows as a DatasetPopulation
    X, y = make_classification(
        1, n=SUSY["n"], dim=SUSY["dim"], spectrum_decay=SUSY["spectrum_decay"],
        label_noise=SUSY["label_noise"], device=dev)
    dpop = DatasetPopulation(X, y, m=SUSY["m"], lam=SUSY["lam"],
                             objective=logistic, device=dev)
    del X, y
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rows_mib = (dpop._rows_X.numel() * 8 + dpop._rows_y.numel() * 8) / 2**20
    hwm0 = rss.high_water()
    w0 = torch.zeros(SUSY["dim"], dtype=torch.float64, device=dev)
    w_star = newton_solve(dpop.eval_problem(), w0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ds = _async_runs(None, w0, w_star,
                     [("sync", 10, CommConfig(scheduler="uniform:0.1",
                                              seed=1))],
                     lambda: make_optimizer("flens_plus", k=SUSY["k"]),
                     "populations SUSY", population=dpop)
    hwm = rss.high_water()
    rss.close()
    dev_peak = ds["sync"]["peak_memory_bytes"] / 2**20
    budget = POP_BUDGET_MIB["dataset"]
    check(hwm - hwm0 < budget["host"],
          f"SUSY population: host RSS high-water grew {hwm - hwm0:.0f} MiB")
    check(dev_peak - rows_mib < budget["device_over_rows"],
          f"SUSY population: device peak {dev_peak:.0f} MiB, rows "
          f"{rows_mib:.0f} MiB")
    out["dataset"] = {"runs": ds, "rows_mib": rows_mib,
                      "host_rss_high_water_mib": hwm,
                      "host_growth_mib": hwm - hwm0,
                      "device_peak_mib": dev_peak,
                      "materialize_ms": _materialize_ms(dpop, 100),
                      "cohort": 100, "budget_mib": budget}
    log(f"[populations] SUSY 5,000,000 rows, m=1000, uniform:0.1: device "
        f"peak {dev_peak:.0f} MiB ({dev_peak - rows_mib:.0f} over the "
        f"{rows_mib:.0f} MiB of rows; budget {budget['device_over_rows']}), "
        f"host RSS high-water {hwm:.0f} MiB (grew {hwm - hwm0:.0f}; budget "
        f"{budget['host']}); materialize a cohort of 100 "
        f"{out['dataset']['materialize_ms']:.3f} ms")
    print("[populations-json] " + json.dumps(out), flush=True)
    return 0


def phase_populations() -> dict:
    """The lock-step anchor across the population drivers, then the
    m = 100,000 and SUSY population runs in a child process."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import SyntheticPopulation, make_optimizer, run_rounds
    from repro_torch.core import newton_solve

    dev = _card()
    # every client's cycle takes the same time on the default channel, so
    # a full-quorum commit lists its members in id order, as sync does
    pop = SyntheticPopulation(m=200, dim=16, seed=2, device=dev)
    w0 = torch.zeros(16, dtype=torch.float64, device=dev)
    w_star = newton_solve(pop.eval_problem(), w0)
    codecs = TRANSPORTS["comp+sched+ef"][1]
    base = dict(seed=1, codecs=codecs, error_feedback=True)
    sync = run_rounds(make_optimizer("flens_plus", k=8), pop, w0, w_star,
                      rounds=3, comm=CommConfig(**base))
    asy = run_rounds(make_optimizer("flens_plus", k=8), pop, w0, w_star,
                     rounds=3, comm=CommConfig(async_mode=True, **base))
    check(bool((sync.loss == asy.loss).all()
               and (sync.cumulative_bytes == asy.cumulative_bytes).all()),
          f"population anchor: sync {sync.loss.tolist()} != async "
          f"{asy.loss.tolist()}")
    log("[populations] anchor: m=200 full scheduler, 3 rounds sync == "
        "full-quorum async, losses and bytes bit-equal")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--population-child"],
        capture_output=True, text=True, timeout=900)
    record = None
    for line in proc.stdout.splitlines():
        if line.startswith("[populations-json] "):
            record = json.loads(line.split(" ", 1)[1])
        else:
            print(line, flush=True)
    check(proc.returncode == 0 and record is not None,
          f"populations child failed ({proc.returncode}): "
          f"{proc.stderr[-3000:]}")
    record["anchor_loss"] = asy.loss.tolist()
    return record


# ---------------------------------------------------------------------------
# 5f. telemetry
# ---------------------------------------------------------------------------

TELEMETRY_DIR = ROOT / "chiprun_out" / "telemetry"
# the kernel each op of FLeNS+ under comp+sched+ef takes at SUSY's shapes
# (n = 32, payload rows of 10-55 values): the warp routes
PROFILED_KERNELS = {"srht_apply": "srht_fwd_warp_kernel",
                    "srht_apply_t": "srht_t_warp_kernel",
                    "topk_mask": "topk_mask_warp_kernel",
                    "qint8_roundtrip": "qint8_warp_kernel"}
TELEMETRY_MODES = ("off", "null", "jsonl")
TELEMETRY_TURNS = 3  # off, null, jsonl; then backwards; then forwards


def _same_trajectory(a, b) -> bool:
    def key(h):
        return (h.loss.tolist(), h.grad_norm.tolist(),
                h.cumulative_bytes.tolist(), h.sim_time_s.tolist(),
                [t.to_dict() for t in h.traces or []],
                None if h.staleness is None else h.staleness.tolist())
    return key(a) == key(b)


def _trace_kernels(path: pathlib.Path) -> dict:
    """Launches of each profiled kernel in an exported Chrome trace."""
    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(k in n for n in names) for k in PROFILED_KERNELS.values()}


def _telemetry_runs(problem, w0, w_star, runs, label: str,
                    population=None) -> dict:
    """Each run (name, rounds, CommConfig or None, optimizer factory,
    rounds to profile): with obs=None, then with a jsonl sink (launches
    counted and checked, trajectory bit-equal, the stream checked by the
    port's report --check-schema, the profiled rounds' kernels read off
    the Chrome trace), then off / null sink / jsonl sink in turns for ms
    a step."""
    from repro_torch.core import run_rounds
    from repro_torch.kernels import ops
    from repro_torch.obs import TelemetryConfig, report

    target = problem if population is None else population
    TELEMETRY_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, rounds, cfg, make_opt, profile in runs:
        tag = f"{label}_{name}".replace(" ", "_").replace("=", "")
        path = TELEMETRY_DIR / f"{tag}.jsonl"
        trace_dir = TELEMETRY_DIR / f"{tag}_trace"

        def run(mode: str, dest: pathlib.Path, profile_rounds: int = 0):
            obs = None
            if mode != "off":
                dest.unlink(missing_ok=True)  # the jsonl sink appends
                obs = TelemetryConfig(
                    sink=f"jsonl:{dest}" if mode == "jsonl" else "null",
                    label=f"{label} {name}", profile_rounds=profile_rounds,
                    profile_dir=str(trace_dir))
            return run_rounds(make_opt(), target, w0, w_star, rounds=rounds,
                              comm=cfg, obs=obs)

        timed = TELEMETRY_DIR / f"{tag}_timed.jsonl"
        off = run("off", timed)
        shutil.rmtree(trace_dir, ignore_errors=True)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        on = run("jsonl", path, profile)
        counts = ops.launch_counts()
        check(_same_trajectory(on, off),
              f"{label} {name}: the trajectory with telemetry on differs "
              f"from the one with it off ({on.loss.tolist()} vs "
              f"{off.loss.tolist()})")
        check(report.main([str(path), "--check-schema"]) == 0,
              f"{label} {name}: {path} fails report --check-schema")
        if cfg is None:  # FLeNS: 3 srht_apply and 2 srht_apply_t a round
            executed = rounds
            want = {"fwht": 0, "srht_apply": 3 * rounds,
                    "srht_apply_t": 2 * rounds, **NO_ROWS, **NO_CODEC,
                    **NO_LM}
        else:
            executed = (sum(_groups_per_commit(on)) + 1 if cfg.async_mode
                        else rounds)  # + the async probe round
            want = _expected_launches(cfg, executed)
        check(counts == want,
              f"{label} {name}: launches {counts} != {want}")
        tel = on.telemetry
        row = {"rounds": rounds, "rounds_executed": executed,
               "launches": counts, "compile_s": tel["compile_s"],
               "exec_s_per_round": tel["exec_s_per_round"],
               "phase_s": tel["phase_s"],
               "setup_phase_s": tel["setup_phase_s"],
               "flight": tel["flight"], "metrics": tel["metrics"]}
        if profile:
            traces = sorted(trace_dir.glob("*.pt.trace.json"))
            check(len(traces) == 1, f"{label} {name}: profiler traces "
                  f"{[p.name for p in traces]} (want one)")
            got = _trace_kernels(traces[0])
            per_round = _expected_launches(cfg, 1)
            want_k = {kernel: profile * per_round[op]
                      for op, kernel in PROFILED_KERNELS.items()}
            check(got == want_k, f"{label} {name}: the profiled rounds "
                  f"launched {got} (want {want_k})")
            row["profiled_kernels"] = got
            row["profile_trace"] = str(traces[0].relative_to(ROOT))
        ms = {mode: [] for mode in TELEMETRY_MODES}
        for turn in range(TELEMETRY_TURNS):
            for mode in (TELEMETRY_MODES if turn % 2 == 0
                         else TELEMETRY_MODES[::-1]):
                hist = run(mode, timed)
                check(_same_trajectory(hist, off),
                      f"{label} {name}: the {mode} run's trajectory differs")
                ms[mode].append(hist.wall_time_s * 1e3 / rounds)
        row["ms_per_step"] = ms
        out[name] = row
        step = "commit" if cfg is not None and cfg.async_mode else "round"
        fl = tel["flight"]
        log(f"[telemetry] {label} {name}: {rounds} {step}s, trajectory "
            f"with telemetry on bit-equal to off; launches {counts}; "
            f"compile_s {tel['compile_s'] * 1e3:.2f} ms, exec_s_per_round "
            f"{tel['exec_s_per_round'] * 1e3:.3f} ms; flight "
            f"{fl['total']} events ({fl['kept']} kept, {fl['truncated']} "
            f"truncated)")
        log(f"[telemetry] {label} {name}: phase_s "
            + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in
                        sorted(tel["phase_s"].items(), key=lambda kv: -kv[1]))
            + "; setup " + ", ".join(
                f"{k} {v * 1e3:.2f} ms" for k, v in
                sorted(tel["setup_phase_s"].items(), key=lambda kv: -kv[1])))
        log(f"[telemetry] {label} {name}: ms a {step} (run_rounds, eval "
            f"included), {TELEMETRY_TURNS} turns each: " + "; ".join(
                f"{mode} " + " / ".join(f"{v:.3f}" for v in ms[mode])
                for mode in TELEMETRY_MODES))
        if profile:
            log(f"[telemetry] {label} {name}: the {profile} profiled rounds "
                f"launched {row['profiled_kernels']} ({row['profile_trace']})")
    return out


def _sink_us(record: dict, reps: int = 5, lines: int = 100) -> dict:
    """Host µs of the jsonl sink on this machine's disk: the first emit
    of a run (it creates and opens the file), a later emit, and the
    close; medians of ``reps`` fresh files of ``lines`` records."""
    from repro_torch.obs import make_sink

    path = TELEMETRY_DIR / "sink_cost.jsonl"
    first, later, close = [], [], []
    for _ in range(reps):
        path.unlink(missing_ok=True)
        sink = make_sink(f"jsonl:{path}")
        t0 = time.perf_counter()
        sink.emit(record)
        t1 = time.perf_counter()
        for _ in range(lines - 1):
            sink.emit(record)
        t2 = time.perf_counter()
        sink.close()
        t3 = time.perf_counter()
        first.append((t1 - t0) * 1e6)
        later.append((t2 - t1) * 1e6 / (lines - 1))
        close.append((t3 - t2) * 1e6)
    path.unlink(missing_ok=True)
    return {name: float(np.median(v)) for name, v in
            (("first_emit_us", first), ("emit_us", later),
             ("close_us", close))}


def phase_telemetry(card: str, problem, w0, w_star, populations: dict) -> dict:
    """The five drivers with telemetry on: FLeNS without transport, FLeNS+
    under comp+sched+ef on the edge channel (its first two rounds
    profiled) and async_buf (K = m/4) on the straggler channel at SUSY's
    full size here; the m = 100,000 population's sync and async runs came
    from the 5e child process."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import FLeNS, make_optimizer

    sketch, codecs, _ = TRANSPORTS["comp+sched+ef"]

    def flens_plus():
        return make_optimizer("flens_plus", k=SUSY["k"])

    runs = [("flens", 10, None, lambda: FLeNS(k=SUSY["k"]), 0),
            ("flens_plus comp+sched+ef", 10,
             CommConfig(codecs=codecs, channel=_edge_channel(problem.m),
                        scheduler="bandwidth:0.5", error_feedback=True,
                        seed=1),
             lambda: FLeNS(k=SUSY["k"], variant="plus", sketch=sketch), 2),
            ("async_buf", 20,
             CommConfig(channel=_straggler_channel(problem.m), seed=1,
                        async_mode=True, buffer_size=max(2, problem.m // 4),
                        staleness="inverse"), flens_plus, 0)]
    out = {"susy": _telemetry_runs(problem, w0, w_star, runs, "SUSY"),
           "population": populations["telemetry"]}
    # what the jsonl sink itself costs here, on a round record of the
    # FLeNS+ run (the sink is the only difference between the null and
    # jsonl runs inside the round loop)
    stream = TELEMETRY_DIR / "SUSY_flens_plus_comp+sched+ef.jsonl"
    sink = _sink_us(json.loads(stream.read_text().splitlines()[0]))
    log(f"[telemetry] jsonl sink on this disk: first emit (creates and "
        f"opens the file) {sink['first_emit_us']:.1f} us, later emits "
        f"{sink['emit_us']:.1f} us each, close {sink['close_us']:.1f} us "
        f"(medians of 5 files of 100 records)")
    log(f"[telemetry] {card}: ms a step with telemetry off / on (null "
        f"sink) / on (jsonl sink), medians of {TELEMETRY_TURNS} turns:")
    for where, rows in out.items():
        for name, row in rows.items():
            med = {m: float(np.median(v)) for m, v in row["ms_per_step"].items()}
            log(f"[telemetry]   {where} {name}: " + " / ".join(
                f"{med[m]:.3f}" for m in TELEMETRY_MODES)
                + f" ms (jsonl - off {med['jsonl'] - med['off']:+.3f})")
    return {**out, "jsonl_sink": sink}


# ---------------------------------------------------------------------------
# 5g. scenario dynamics
# ---------------------------------------------------------------------------

DYNAMICS_DIR = TELEMETRY_DIR.parent / "dynamics"
# the counters repro_torch.dynamics feeds (robust_stats mirrored into
# telemetry, churn's departures, async retirements)
DYNAMICS_COUNTERS = ("clients_departed", "uploads_retired",
                     "uploads_corrupted", "uploads_clipped", "uploads_trimmed")
# examples/edge_clients.py:291-292: robust aggregation wants dense payloads
DENSE_CODECS = {"h_sk": "sympack+qint8", "sg": "qint8", "grad": "qint8"}
DYNAMICS_TURNS = ("off", "on", "on", "off")  # ms a step, in turns


def _churn_dynamics():
    """examples/edge_clients.py:260-274: churn with a diurnal uplink and
    regional outages."""
    from repro_torch.dynamics import ChannelProcess, DynamicsConfig

    return DynamicsConfig(
        churn="poisson:0.05", seed=1,
        channel=ChannelProcess(uplink_bytes_per_s="sin:24,0.5",
                               outage="outage:0.05,3,16", seed=1))


def _threat_dynamics(threat: "str | None", robust: "str | None" = None):
    from repro_torch.dynamics import DynamicsConfig

    return (DynamicsConfig(threat=threat, robust=robust, seed=1)
            if threat else None)


def _dynamics_runs(problem, w0, w_star, runs, label: str,
                   population=None) -> dict:
    """Each run (name, rounds, CommConfig, optimizer factory, rounds to
    profile): run_rounds with telemetry on through the kernels (launches
    counted and checked, the dynamics counters and the alive count read
    off the telemetry), again through the plain versions (trajectory and
    counters bit-equal), then, for a run with dynamics, bare steps with
    dynamics off and on in turns for ms a step."""
    from repro_torch.core import run_rounds
    from repro_torch.kernels import ops
    from repro_torch.obs import TelemetryConfig

    target = problem if population is None else population
    out = {}
    for name, rounds, cfg, make_opt, profile in runs:
        trace_dir = DYNAMICS_DIR / f"{label}_{name}_trace".replace(" ", "_")

        def run(impl=None, profile_rounds=0):
            obs = TelemetryConfig(label=f"{label} {name}",
                                  profile_rounds=profile_rounds,
                                  profile_dir=str(trace_dir))
            with ops.use_impl(impl):
                return run_rounds(make_opt(), target, w0, w_star,
                                  rounds=rounds, comm=cfg, obs=obs)

        shutil.rmtree(trace_dir, ignore_errors=True)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        hist = run(profile_rounds=profile)
        counts = ops.launch_counts()
        executed = (sum(_groups_per_commit(hist)) + 1 if cfg.async_mode
                    else rounds)  # + the async probe round
        want = _expected_launches(cfg, executed)
        check(counts == want, f"{label} {name}: launches {counts} != {want}")
        check(bool(np.isfinite(hist.loss).all()),
              f"{label} {name}: non-finite loss {hist.loss.tolist()}")
        plain = run("ref")
        metrics = hist.telemetry["metrics"]
        stats = {k: metrics["counters"][k] for k in DYNAMICS_COUNTERS
                 if k in metrics["counters"]}
        plain_stats = {k: plain.telemetry["metrics"]["counters"][k]
                       for k in stats}
        check(_same_trajectory(hist, plain) and stats == plain_stats,
              f"{label} {name}: the run through the kernels "
              f"({hist.loss.tolist()}, {stats}) differs from the plain "
              f"versions' ({plain.loss.tolist()}, {plain_stats})")
        row = {"rounds": rounds, "async": cfg.async_mode,
               "dynamics": (cfg.dynamics.describe() if cfg.dynamics
                            else None),
               "loss": hist.loss.tolist(), "gap": hist.gap.tolist(),
               "cumulative_bytes": hist.cumulative_bytes.tolist(),
               "sim_time_s": float(hist.sim_time_s[-1]),
               "rounds_executed": executed, "launches": counts,
               "stats": stats,
               "alive_last": metrics["gauges"].get("active_population")}
        if profile:
            traces = sorted(trace_dir.glob("*.pt.trace.json"))
            check(len(traces) == 1, f"{label} {name}: profiler traces "
                  f"{[p.name for p in traces]} (want one)")
            got = _trace_kernels(traces[0])
            per_round = _expected_launches(cfg, 1)
            want_k = {kernel: profile * per_round[op]
                      for op, kernel in PROFILED_KERNELS.items()}
            check(got == want_k, f"{label} {name}: the profiled rounds "
                  f"launched {got} (want {want_k})")
            row["profiled_kernels"] = got
            row["profile_trace"] = str(traces[0].relative_to(ROOT))
        step = "commit" if cfg.async_mode else "round"
        log(f"[dynamics] {label} {name}: {rounds} {step}s, gap "
            f"{hist.gap[0]:.3e} -> {hist.gap[-1]:.3e}, "
            f"{hist.cumulative_bytes[-1]:.0f} B, sim {row['sim_time_s']:.2f}"
            f" s; launches {counts}; equal to the plain versions'; "
            f"stats {stats}; alive at the last {step} {row['alive_last']}")
        if profile:
            log(f"[dynamics] {label} {name}: the {profile} profiled rounds "
                f"launched {row['profiled_kernels']} ({row['profile_trace']})")
        if cfg.dynamics is not None:
            off_cfg = dataclasses.replace(cfg, dynamics=None)
            ms = {"off": [], "on": []}
            for mode in DYNAMICS_TURNS:
                bare = _bare_commits(
                    make_opt(), problem, w0, cfg if mode == "on" else off_cfg,
                    min(rounds, 20), population, profiled=False)
                ms[mode].append(bare["median_ms"])
            row["bare_ms"] = ms
            med = {k: float(np.median(v)) for k, v in ms.items()}
            log(f"[dynamics] {label} {name}: bare ms a {step} (medians of "
                f"{min(rounds, 20)}, {len(DYNAMICS_TURNS) // 2} turns each) "
                f"without dynamics " + " / ".join(f"{v:.3f}" for v in ms["off"])
                + ", with " + " / ".join(f"{v:.3f}" for v in ms["on"])
                + f": {med['on'] - med['off']:+.3f} ms")
        out[name] = row
    return out


def _arms_gaps(runs: dict, label: str, clean: str, arms) -> dict:
    """The arms of one comparison transmit equal bytes (checked); their
    final-loss gaps to the clean run (printed, not checked)."""
    ref = runs[clean]["cumulative_bytes"]
    for arm in arms:
        check(runs[arm]["cumulative_bytes"] == ref,
              f"{label}: {arm} transmitted other bytes than {clean}")
    gaps = {arm: runs[arm]["loss"][-1] - runs[clean]["loss"][-1]
            for arm in arms}
    log(f"[dynamics] {label}: bytes equal across {[clean, *arms]}; final-loss "
        f"gap to {clean}: " + ", ".join(f"{a} {g:+.3e}"
                                         for a, g in gaps.items()))
    return gaps


def _population_dynamics(pop, w0, w_star, q: float) -> dict:
    """5g's population rows (examples/edge_clients.py:254-321) at
    ``uniform:q``, 10 rounds each: churn under the population codecs, and
    the noise coalition with and without the trimmed mean under the
    dense codecs beside the clean dense run."""
    from repro_torch.comm import ChannelModel, CommConfig
    from repro_torch.core import make_optimizer

    base = dict(channel=ChannelModel(**POP_EDGE), scheduler=f"uniform:{q}",
                seed=1)
    rows = [("churn", CommConfig(codecs=TRANSPORTS["comp+sched+ef"][1],
                                 dynamics=_churn_dynamics(), **base))]
    for arm, robust in (("clean", None), ("noise", None),
                        ("noise trimmed", "trimmed:0.1")):
        rows.append((arm, CommConfig(
            codecs=DENSE_CODECS, dynamics=_threat_dynamics(
                None if arm == "clean" else "noise:0.1,5", robust), **base)))
    DYNAMICS_DIR.mkdir(parents=True, exist_ok=True)
    label = f"m={pop.m}"
    runs = _dynamics_runs(
        None, w0, w_star,
        [(name, 10, cfg, lambda: make_optimizer("flens_plus", k=8), 0)
         for name, cfg in rows], label, population=pop)
    return {"m": pop.m, "runs": runs, "gaps": _arms_gaps(
        runs, f"{label} noise arms", "clean", ("noise", "noise trimmed"))}


def phase_dynamics(card: str, problem, w0, w_star, populations: dict) -> dict:
    """FLeNS+ at SUSY's full size under scenario dynamics: churn with a
    diurnal uplink and regional outages under comp+sched+ef on the edge
    channel (sync 10 rounds, its first two profiled, and async_buf K =
    m/4 20 commits), and bench_robust's arms (clean, signflip:0.1,
    signflip:0.1 with trimmed:0.1) under the dense codecs on the
    straggler channel; the m = 100,000 population rows came from the 5e
    child process."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import FLeNS

    sketch, codecs, _ = TRANSPORTS["comp+sched+ef"]

    def flens_plus():
        return FLeNS(k=SUSY["k"], variant="plus", sketch=sketch)

    churn = CommConfig(codecs=codecs, channel=_edge_channel(problem.m),
                       scheduler="bandwidth:0.5", error_feedback=True,
                       seed=1, dynamics=_churn_dynamics())
    runs = [("churn sync", 10, churn, flens_plus, 2),
            ("churn async_buf", 20, dataclasses.replace(
                churn, async_mode=True, buffer_size=max(2, problem.m // 4),
                staleness="inverse"), flens_plus, 0)]
    straggler = _straggler_channel(problem.m)
    for arm, threat, robust in (("clean", None, None),
                                ("signflip", "signflip:0.1", None),
                                ("signflip trimmed", "signflip:0.1",
                                 "trimmed:0.1")):
        runs.append((arm, 10, CommConfig(
            codecs=DENSE_CODECS, channel=straggler, seed=1,
            dynamics=_threat_dynamics(threat, robust)), flens_plus, 0))
    DYNAMICS_DIR.mkdir(parents=True, exist_ok=True)
    susy = _dynamics_runs(problem, w0, w_star, runs, "SUSY")
    gaps = _arms_gaps(susy, "SUSY bench_robust arms", "clean",
                      ("signflip", "signflip trimmed"))
    log(f"[dynamics] {card}: the cost of dynamics, bare ms a step with "
        f"dynamics minus without (medians of two turns each):")
    for where, rows in (("SUSY", susy),
                        (f"m={populations['m']}", populations["runs"])):
        for name, row in rows.items():
            if "bare_ms" in row:
                med = {k: float(np.median(v))
                       for k, v in row["bare_ms"].items()}
                log(f"[dynamics]   {where} {name}: {med['off']:.3f} -> "
                    f"{med['on']:.3f} ms ({med['on'] - med['off']:+.3f})")
    return {"susy": susy, "gaps": gaps, "population": populations}


# ---------------------------------------------------------------------------
# 5h. distributed
# ---------------------------------------------------------------------------

DIST_DIR = ROOT / "chiprun_out" / "distributed"
# DistributedFLeNS at SUSY's size: beta 0 (the simulator's FLeNS without
# its guard is the same step), 10 rounds, 4 gloo ranks on the one card
DIST = dict(rounds=10, ranks=4, tol=1e-10, timeout_s=300)
DIST_LAUNCHES = {"srht_apply": 3, "srht_apply_t": 2}  # a round, a rank


def _susy_rows(dev):
    """SUSY's rows and labels (phase 5's, seed 1) on ``dev``."""
    from repro_torch.data import make_classification

    return make_classification(
        1, n=SUSY["n"], dim=SUSY["dim"], spectrum_decay=SUSY["spectrum_decay"],
        label_noise=SUSY["label_noise"], device=dev)


def _dist_flens(mesh):
    from repro_torch.core import logistic
    from repro_torch.core.distributed import DistributedFLeNS

    return DistributedFLeNS(mesh=mesh, objective=logistic, dim=SUSY["dim"],
                            k=SUSY["k"], lam=SUSY["lam"], beta=0.0,
                            client_axes=("data",))


def _dist_rounds(step, X, y, rounds: int) -> dict:
    """``rounds`` rounds of a DistributedFLeNS step from w = 0, each timed
    on the host clock around work that ends in a synchronize, with the
    launches of the rounds counted (reset just before, read just after)."""
    from repro_torch.kernels import ops

    w = w_prev = torch.zeros(SUSY["dim"], dtype=torch.float64,
                             device=X.device)
    ws, ms = [], []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for t in range(rounds):
        t0 = time.perf_counter()
        w, w_prev = step(X, y, w, w_prev, t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        ws.append(w)
    return {"w": torch.stack(ws), "ms": ms, "launches": ops.launch_counts()}


def _simulator_rounds(X, y, m: int, rounds: int) -> dict:
    """The port's simulator FLeNS(k, beta=0, restart=False) on the same
    rows cut in m contiguous clients, round t keyed by key_from_ints(t):
    the operators DistributedFLeNS draws from the round seed t; then
    three more rounds profiled."""
    from repro_torch.core import FederatedProblem, FLeNS, logistic
    from repro_torch.keys import key_from_ints

    dim = SUSY["dim"]
    problem = FederatedProblem(
        X=X.reshape(m, -1, dim), y=y.reshape(m, -1),
        mask=torch.ones(m, X.shape[0] // m, dtype=X.dtype, device=X.device),
        lam=SUSY["lam"], objective=logistic)
    opt = FLeNS(k=SUSY["k"], beta=0.0, restart=False)
    state = opt.init(problem, torch.zeros(dim, dtype=X.dtype, device=X.device))
    ws, ms = [], []
    torch.cuda.synchronize()
    for t in range(rounds):
        t0 = time.perf_counter()
        state = opt.round(problem, state, key_from_ints(t))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        ws.append(state["w"])
    profile = _profile_rounds(opt, problem, state,
                              [key_from_ints(rounds + i) for i in range(3)])
    return {"w": torch.stack(ws), "ms": ms, "profile": profile}


def _iterate_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| in the iterates' own dtype."""
    return float((got - want).abs().max() / want.abs().max())


def _median(ms: list) -> float:
    """The median round after the first (which opens the communicator)."""
    return float(np.median(ms[1:]))


def distributed_child(job_path: str, rank: int) -> int:
    """One rank of 5h (b): SUSY from its seed on the card, this rank's
    rows, DistributedFLeNS over gloo on CUDA tensors; writes its iterates,
    round times and launches. Loads the kernels the parent's build phase
    built (a missing library fails: no rank builds it)."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh, process_group

    job = json.loads(pathlib.Path(job_path).read_text())
    check(_build._target(_build.CSRC / "srht.cu").exists(),
          "distributed child: srht.cu is not built (the parent builds it)")
    dev = _card()
    torch.cuda.set_device(dev)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // job["ranks"]))
    _build.module()
    X, y = _susy_rows(dev)
    with process_group(rank, job["ranks"], job["store"], backend="gloo",
                       timeout_s=job["timeout_s"]):
        mesh = make_mesh((job["ranks"],), ("data",), "cuda")
        flens = _dist_flens(mesh)
        Xs, ys = (a.clone() for a in flens.shard_data(X, y))
        del X, y
        torch.cuda.empty_cache()
        step = flens.round_fn()
        torch.distributed.barrier()
        run = _dist_rounds(step, Xs, ys, job["rounds"])
    np.savez(pathlib.Path(job["out"]) / f"rank{rank}.npz",
             w=run["w"].cpu().numpy(), ms=np.array(run["ms"]),
             rows=np.array([Xs.shape[0]]),
             launches=np.array(json.dumps(run["launches"])))
    return 0


def phase_distributed(card: str) -> dict:
    """(a) one NCCL rank on the whole of SUSY against the simulator at
    m = 1, a round profiled; (b) 4 gloo ranks on the card against the
    simulator at m = 4, bit-equal to each other."""
    from repro_torch.launch.mesh import make_mesh, process_group, spawn

    t_phase = time.perf_counter()
    dev = _card()
    rounds, tol = DIST["rounds"], DIST["tol"]
    want = {"fwht": 0, **{op: n * rounds for op, n in DIST_LAUNCHES.items()},
            **NO_ROWS, **NO_CODEC, **NO_LM}
    if DIST_DIR.exists():
        shutil.rmtree(DIST_DIR)
    DIST_DIR.mkdir(parents=True)
    X, y = _susy_rows(dev)
    out = {"rows": SUSY["n"], "dim": SUSY["dim"], "k": SUSY["k"],
           "rounds": rounds, "tolerance": tol}

    # (a) one rank: NCCL, the whole dataset as one client
    torch.cuda.set_device(dev)
    with process_group(0, 1, DIST_DIR / "store_one", backend="nccl",
                       timeout_s=120):
        flens = _dist_flens(make_mesh((1,), ("data",), "cuda"))
        step = flens.round_fn()
        Xs, ys = flens.shard_data(X, y)
        one = _dist_rounds(step, Xs, ys, rounds)
        w_last = one["w"][-1]
        profile = _profile_steps(
            lambda: step(Xs, ys, w_last, w_last, rounds), 1)
    check(one["launches"] == want,
          f"distributed (a): launches {one['launches']} != {want}")
    sim1 = _simulator_rounds(X, y, 1, rounds)
    err1 = _iterate_rel_err(one["w"], sim1["w"])
    check(bool(torch.isfinite(one["w"]).all()) and err1 <= tol,
          f"distributed (a): one rank differs from the simulator at m = 1 "
          f"by {err1:.3e} > {tol} (relative)")
    a = {"backend": "nccl", "ms": one["ms"], "ms_median": _median(one["ms"]),
         "simulator_ms": sim1["ms"],
         "simulator_ms_median": _median(sim1["ms"]),
         "simulator_profile": sim1["profile"], "rel_err": err1,
         "launches": one["launches"],
         "launches_per_round": {op: one["launches"][op] / rounds
                                for op in DIST_LAUNCHES},
         "profile": profile}
    out["one_rank"] = a
    del one, sim1, Xs, ys, step, flens
    log(f"[distributed] (a) 1 NCCL rank, {SUSY['n']:,} x {SUSY['dim']} f64, "
        f"k {SUSY['k']}: {a['ms_median']:.3f} ms a round (median of rounds "
        f"2-{rounds}; first {a['ms'][0]:.1f}), simulator m = 1 "
        f"{a['simulator_ms_median']:.3f} ms; w within {err1:.2e} of the "
        f"simulator's (tol {tol}); launches {a['launches_per_round']} a round")
    log(f"[distributed]   a profiled round: device busy "
        f"{profile['busy_share']:.1%} of {profile['wall_us'] / 1e3:.3f} ms")
    for r in profile["top"][:6]:
        log(f"[distributed]     {r['us_per_round']:9.1f} us x"
            f"{r['launches_per_round']:.0f}  {r['kernel']}")

    # (b) four ranks on the one card: gloo over CUDA tensors
    ranks = DIST["ranks"]
    sim4 = _simulator_rounds(X, y, ranks, rounds)
    del X, y
    torch.cuda.empty_cache()
    job = {"ranks": ranks, "rounds": rounds, "store": str(DIST_DIR / "store"),
           "out": str(DIST_DIR), "timeout_s": DIST["timeout_s"]}
    (DIST_DIR / "job.json").write_text(json.dumps(job))
    t0 = time.perf_counter()
    spawn(lambda r: [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--distributed-child", str(DIST_DIR / "job.json"),
                     str(r)], ranks, timeout_s=DIST["timeout_s"])
    spawn_s = time.perf_counter() - t0
    got = [np.load(DIST_DIR / f"rank{r}.npz") for r in range(ranks)]
    w4 = [torch.from_numpy(g["w"]).to(dev) for g in got]
    launches = [json.loads(str(g["launches"])) for g in got]
    for r in range(ranks):
        check(int(got[r]["rows"][0]) == SUSY["n"] // ranks,
              f"distributed (b): rank {r} holds {int(got[r]['rows'][0])} rows")
        check(launches[r] == want,
              f"distributed (b): rank {r} launches {launches[r]} != {want}")
        check(torch.equal(w4[r], w4[0]),
              f"distributed (b): rank {r}'s iterates differ from rank 0's")
    err4 = _iterate_rel_err(w4[0], sim4["w"])
    check(bool(torch.isfinite(w4[0]).all()) and err4 <= tol,
          f"distributed (b): {ranks} ranks differ from the simulator at "
          f"m = {ranks} by {err4:.3e} > {tol} (relative)")
    rank_ms = [g["ms"].tolist() for g in got]
    b = {"backend": "gloo", "ms": rank_ms,
         "ms_median": [_median(ms) for ms in rank_ms],
         "simulator_ms": sim4["ms"],
         "simulator_ms_median": _median(sim4["ms"]),
         "simulator_profile": sim4["profile"], "rel_err": err4,
         "bitwise_equal_ranks": True, "launches": launches,
         "launches_per_round": [{op: n[op] / rounds for op in DIST_LAUNCHES}
                                for n in launches],
         "spawn_s": spawn_s}
    out["four_ranks"] = b
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[distributed] (b) {ranks} gloo ranks on one card, "
        f"{SUSY['n'] // ranks:,} rows each: "
        + " / ".join(f"{ms:.3f}" for ms in b["ms_median"])
        + f" ms a round (medians by rank), simulator m = {ranks} "
        f"{b['simulator_ms_median']:.3f} ms; ranks bit-equal, w within "
        f"{err4:.2e} of the simulator's; launches "
        f"{b['launches_per_round'][0]} a round a rank; spawn to join "
        f"{spawn_s:.1f} s")
    for m, prof in ((1, a["simulator_profile"]),
                    (ranks, b["simulator_profile"])):
        log(f"[distributed]   simulator m = {m}, 3 profiled rounds: device "
            f"busy {prof['busy_share']:.1%} of "
            f"{prof['wall_us'] / prof['rounds'] / 1e3:.3f} ms a round")
        for r in prof["top"][:5]:
            log(f"[distributed]     {r['us_per_round']:9.1f} us/round x"
                f"{r['launches_per_round']:.0f}  {r['kernel']}")
    log(f"[distributed] on {card}; phase 5h took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 5i. cohorts split over ranks
# ---------------------------------------------------------------------------

CM_DIR = ROOT / "chiprun_out" / "client_mesh"
# FLeNS+ (k 10) on SUSY's rows as a DatasetPopulation of m 1000,
# uniform:0.1 (a cohort of 100), phase 5e's edge channel (10% dropout)
# and comp+sched+ef's codecs with EF, 10 rounds; the async driver on the
# straggler channel, 5 commits; 4 gloo ranks on the one card, 25 clients
# of a cohort each
CLIENT_MESH = dict(rounds=10, commits=5, ranks=4, tol=1e-10, timeout_s=420,
                   q=0.1)
CM_KERNELS = ("srht_apply", "srht_apply_t", "topk_mask", "qint8_roundtrip")
# one MoE layer at arctic-480b's widths (d_model 7168, moe_d_ff 4864,
# top-2) with 8 of its 128 experts, float32: the expert branch on a
# ("model",) mesh of 2 ranks at (2, 2304) tokens (b t > 4096), the decode
# branch on a (2 data, 2 model) mesh at (4, 16)
MOE_GRAD = dict(arch="arctic-480b", n_experts=8, expert=(2, 2304),
                decode=(4, 16), tol=1e-4, seed=0)


def _cm_configs():
    """5i's (sync, async) transports."""
    from repro_torch.comm import ChannelModel, CommConfig

    base = dict(codecs=TRANSPORTS["comp+sched+ef"][1], seed=1,
                scheduler=f"uniform:{CLIENT_MESH['q']}", error_feedback=True)
    return (CommConfig(channel=ChannelModel(**POP_EDGE), **base),
            CommConfig(channel=_straggler_channel(SUSY["m"]), async_mode=True,
                       buffer_size=50, staleness="inverse", **base))


def _susy_population(dev):
    """SUSY's rows as a DatasetPopulation of m clients, w0 and w*."""
    from repro_torch.core import DatasetPopulation, logistic, newton_solve

    X, y = _susy_rows(dev)
    pop = DatasetPopulation(X, y, m=SUSY["m"], lam=SUSY["lam"],
                            objective=logistic, device=dev)
    del X, y
    torch.cuda.empty_cache()
    w0 = torch.zeros(SUSY["dim"], dtype=torch.float64, device=dev)
    return pop, w0, newton_solve(pop.eval_problem(), w0)


def _cm_run(pop, w0, w_star, cfg, rounds: int, mesh) -> dict:
    """run_rounds of FLeNS+ with ``client_mesh=mesh``: the iterate of
    every round the optimizer ran (an async commit's group rounds too),
    the losses, bytes and launches (reset just before, read just after),
    ms a round (the loop's wall time over the rounds, evaluation
    included) and, for the sync driver, the median of the times between
    one round's start and the next's after the first (which opens a
    communicator; the loop reads the loss back every round)."""
    from repro_torch.core import make_optimizer, run_rounds
    from repro_torch.kernels import ops

    opt = make_optimizer("flens_plus", k=SUSY["k"])
    ws, starts = [], []
    inner = opt.round

    def round_(problem, state, key, comm=None):
        starts.append(time.perf_counter())
        out = inner(problem, state, key, comm=comm)
        ws.append(out["w"])
        return out

    opt.round = round_
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    hist = run_rounds(opt, pop, w0, w_star, rounds, comm=cfg,
                      client_mesh=mesh)
    counts = {k: v for k, v in ops.launch_counts().items()}
    groups = (_groups_per_commit(hist) if cfg.async_mode else [1] * rounds)
    executed = sum(groups) + (1 if cfg.async_mode else 0)  # + the probe
    return {"w": torch.stack(ws), "loss": hist.loss,
            "bytes": hist.cumulative_bytes,
            "traces": [t.to_dict() for t in hist.traces],
            "launches": counts,
            "want": _expected_launches(cfg, executed),
            "ms_per_round": hist.wall_time_s * 1e3 / rounds,
            "ms_median": (None if cfg.async_mode else
                          _median(list(np.diff(starts) * 1e3))),
            "ef_residuals": hist.ef_residuals}


def _cm_profile(pop, w0, w_star, cfg, mesh) -> dict:
    """One round of run_rounds under the profiler (init and evaluation
    included)."""
    from repro_torch.core import make_optimizer, run_rounds

    return _profile_steps(lambda: run_rounds(
        make_optimizer("flens_plus", k=SUSY["k"]), pop, w0, w_star, 1,
        comm=cfg, client_mesh=mesh), 1)


def _moe_grad_cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MOE_GRAD["arch"]),
                               n_experts=MOE_GRAD["n_experts"],
                               param_dtype=torch.float32,
                               dtype=torch.float32)


def _moe_backward(params: dict, x, g, cfg, mesh) -> "tuple[dict, float]":
    """Gradients of sum(out * g) + aux through moe_apply under ``mesh``
    (x's and every parameter's; the parameters are the leaves), and the
    forward and backward's ms on the host clock."""
    from repro_torch.models import moe
    from repro_torch.sharding.ctx import use_mesh

    x = x.clone().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with use_mesh(mesh):
        o, aux, _ = moe.moe_apply(params, x, cfg)
    (torch.sum(o * g) + aux).backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    grads = {"x": x.grad, **{k: v.grad for k, v in params.items()}}
    for v in params.values():
        v.grad = None
    return grads, ms


def _moe_grad_child(job: dict, rank: int) -> dict:
    """One rank of 5i (d): the one-process backward of the layer on the
    card, then this rank's backward on each mesh it belongs to, each
    gradient held to its slice of the one-process one."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import rules

    dev = _card()
    cfg = _moe_grad_cfg()
    gen = torch.Generator(device=dev).manual_seed(MOE_GRAD["seed"])
    params = moe.moe_init(gen, cfg)
    meshes = {"expert": (DeviceMesh("cuda", torch.arange(2),
                                    mesh_dim_names=("model",)), (0, 1)),
              "decode": (make_mesh((2, 2), ("data", "model"), "cuda"),
                         (0, 1, 2, 3))}
    out = {}
    for name, (mesh, members) in meshes.items():
        # every rank draws every case's inputs: the generator stays in step
        b, t = MOE_GRAD[name]
        x = torch.randn((b, t, cfg.d_model), generator=gen, device=dev)
        g = torch.randn((b, t, cfg.d_model), generator=gen, device=dev)
        if rank not in members:
            continue
        for v in params.values():
            v.requires_grad_(True)
        # the second of two calls is timed (the first initialises the
        # libraries and the allocator)
        _moe_backward(params, x, g, cfg, None)
        whole, one_ms = _moe_backward(params, x, g, cfg, None)
        branch = moe.moe_branch(mesh, b, t)
        spec = rules.batch_spec(mesh, (), x)
        want = {"x": rules.local_shard(mesh, whole.pop("x"), spec).clone()}
        for k, v in whole.items():
            pspec = moe.moe_param_spec(mesh, ("moe", k), v, branch=branch)
            want[k] = rules.local_shard(mesh, v, pspec).clone()
        del whole
        local = {k: v.detach().clone().requires_grad_()
                 for k, v in moe.moe_local_params(mesh, params,
                                                  branch).items()}
        xs, gs = rules.local_shard(mesh, x, spec), rules.local_shard(mesh, g,
                                                                     spec)
        _moe_backward(local, xs, gs, cfg, mesh)
        got, mesh_ms = _moe_backward(local, xs, gs, cfg, mesh)
        out[name] = {
            "branch": branch, "one_process_ms": one_ms, "mesh_ms": mesh_ms,
            "rel_err": {k: float((got[k] - want[k]).abs().max()
                                 / want[k].abs().max()) for k in want},
            "finite": all(bool(torch.isfinite(v).all())
                          for v in got.values()),
            "shapes": {k: list(v.shape) for k, v in got.items()}}
        del got, want, local
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    return out


def client_mesh_child(job_path: str, rank: int) -> int:
    """One rank of 5i (b) and (c) (SUSY's population on the card, this
    rank's block of each cohort, gloo over CUDA tensors) or of 5i (d)
    (the MoE backward); writes its results. Loads the kernels the
    parent's build phase built."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh, process_group

    job = json.loads(pathlib.Path(job_path).read_text())
    check(_build._target(_build.CSRC / "srht.cu").exists(),
          "client-mesh child: srht.cu is not built (the parent builds it)")
    dev = _card()
    torch.cuda.set_device(dev)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // job["ranks"]))
    out = {}
    if job["kind"] == "moe":
        with process_group(rank, job["ranks"], job["store"], backend="gloo",
                           timeout_s=job["timeout_s"]):
            out["moe"] = _moe_grad_child(job, rank)
        (pathlib.Path(job["out"]) / f"moe{rank}.json").write_text(
            json.dumps(out))
        return 0
    _build.module()
    _build.module("codec")
    pop, w0, w_star = _susy_population(dev)
    sync, asyn = _cm_configs()
    arrays = {}
    with process_group(rank, job["ranks"], job["store"], backend="gloo",
                       timeout_s=job["timeout_s"]):
        mesh = make_mesh((job["ranks"],), ("data",), "cuda")
        torch.distributed.barrier()
        for name, cfg, n in (("sync", sync, job["rounds"]),
                             ("async", asyn, job["commits"])):
            run = _cm_run(pop, w0, w_star, cfg, n, mesh)
            arrays[f"{name}_w"] = run.pop("w").cpu().numpy()
            arrays[f"{name}_loss"] = run.pop("loss")
            arrays[f"{name}_bytes"] = run.pop("bytes")
            out[name] = run
        out["profile"] = _cm_profile(pop, w0, w_star, sync, mesh)
    np.savez(pathlib.Path(job["out"]) / f"rank{rank}.npz", **arrays)
    (pathlib.Path(job["out"]) / f"rank{rank}.json").write_text(
        json.dumps(out, default=str))
    return 0


def _cm_check_run(label: str, got: dict, want: dict, *, bitwise: bool,
                  tol: float) -> float:
    """A split run against the one-process run: launches as FLeNS+ and
    the codec chains imply, bytes and traces equal, the iterates bit-equal
    or within ``tol`` (relative); returns the relative error."""
    check(got["launches"] == got["want"],
          f"{label}: launches {got['launches']} != {got['want']}")
    check(got["launches"] == want["launches"],
          f"{label}: launches {got['launches']} != the one-process run's "
          f"{want['launches']}")
    check(np.array_equal(got["bytes"], want["bytes"])
          and got["traces"] == want["traces"],
          f"{label}: bytes or traces differ from the one-process run's")
    gw = torch.as_tensor(got["w"])
    ww = torch.as_tensor(want["w"]).to(gw.device)
    check(gw.shape == ww.shape and bool(torch.isfinite(gw).all()),
          f"{label}: iterates {tuple(gw.shape)} against {tuple(ww.shape)}")
    err = _iterate_rel_err(gw, ww)
    if bitwise:
        check(torch.equal(gw, ww),
              f"{label}: not bit-equal to the one-process run ({err:.3e})")
    check(err <= tol, f"{label}: {err:.3e} > {tol} from the one-process run")
    return err


def phase_client_mesh(card: str) -> dict:
    """(a) one NCCL rank: FLeNS+ on SUSY's population split over a 1-rank
    client mesh, bit-equal to the run without a mesh; (b) 4 gloo ranks on
    the card, 25 clients of each cohort a rank, bit-equal to each other
    and within 1e-10 of the one-process run; (c) the async driver the
    same way; (d) the MoE backward on two meshes against the one-process
    backward on the card."""
    from repro_torch.launch.mesh import make_mesh, process_group, spawn

    t_phase = time.perf_counter()
    dev = _card()
    spec = CLIENT_MESH
    tol, ranks = spec["tol"], spec["ranks"]
    if CM_DIR.exists():
        shutil.rmtree(CM_DIR)
    CM_DIR.mkdir(parents=True)
    sync, asyn = _cm_configs()
    pop, w0, w_star = _susy_population(dev)
    cohort = sync.scheduler.cohort_size(SUSY["m"])
    out = {"rows": SUSY["n"], "dim": SUSY["dim"], "m": SUSY["m"],
           "cohort": cohort, "rounds": spec["rounds"],
           "commits": spec["commits"], "tolerance": tol}

    # one process, no mesh: the runs every split run is held to
    plain = {"sync": _cm_run(pop, w0, w_star, sync, spec["rounds"], None),
             "async": _cm_run(pop, w0, w_star, asyn, spec["commits"], None)}
    for name, run in plain.items():
        check(run["launches"] == run["want"],
              f"client mesh, one process {name}: launches "
              f"{run['launches']} != {run['want']}")
        check(bool(np.isfinite(run["loss"]).all())
              and run["loss"][-1] < run["loss"][0],
              f"client mesh, one process {name}: loss {run['loss'].tolist()}")
    plain_profile = _cm_profile(pop, w0, w_star, sync, None)

    # (a) one NCCL rank: the cohort's one block, the gather through NCCL
    torch.cuda.set_device(dev)
    with process_group(0, 1, CM_DIR / "store_one", backend="nccl",
                       timeout_s=120):
        mesh = make_mesh((1,), ("data",), "cuda")
        one = _cm_run(pop, w0, w_star, sync, spec["rounds"], mesh)
        one_profile = _cm_profile(pop, w0, w_star, sync, mesh)
    _cm_check_run("client mesh (a) one NCCL rank", one, plain["sync"],
                  bitwise=True, tol=0.0)
    check(one["ef_residuals"] == plain["sync"]["ef_residuals"],
          "client mesh (a): EF residuals differ from the one-process run's")
    out["one_rank"] = {"backend": "nccl", "ms_per_round": one["ms_per_round"],
                       "ms_median": one["ms_median"],
                       "launches": one["launches"], "profile": one_profile,
                       "bitwise_equal": True}
    out["one_process"] = {k: {"ms_per_round": v["ms_per_round"],
                              "ms_median": v["ms_median"],
                              "launches": v["launches"]}
                          for k, v in plain.items()}
    out["one_process"]["profile"] = plain_profile
    del pop
    torch.cuda.empty_cache()

    # (b), (c) four gloo ranks on the one card
    job = {"kind": "rounds", "ranks": ranks, "rounds": spec["rounds"],
           "commits": spec["commits"], "store": str(CM_DIR / "store"),
           "out": str(CM_DIR), "timeout_s": spec["timeout_s"]}
    (CM_DIR / "job.json").write_text(json.dumps(job))
    t0 = time.perf_counter()
    spawn(lambda r: [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--client-mesh-child", str(CM_DIR / "job.json"), str(r)],
          ranks, timeout_s=spec["timeout_s"])
    spawn_s = time.perf_counter() - t0
    for name in ("sync", "async"):
        runs = []
        for r in range(ranks):
            rec = json.loads((CM_DIR / f"rank{r}.json").read_text())
            arr = np.load(CM_DIR / f"rank{r}.npz")
            run = {**rec[name], "w": torch.from_numpy(arr[f"{name}_w"]),
                   "loss": arr[f"{name}_loss"], "bytes": arr[f"{name}_bytes"]}
            runs.append((rec, run))
        errs = []
        for r, (_, run) in enumerate(runs):
            check(torch.equal(run["w"], runs[0][1]["w"])
                  and np.array_equal(run["loss"], runs[0][1]["loss"]),
                  f"client mesh ({'b' if name == 'sync' else 'c'}): rank "
                  f"{r}'s iterates differ from rank 0's")
            errs.append(_cm_check_run(
                f"client mesh ({'b' if name == 'sync' else 'c'}) rank {r}",
                run, {**plain[name], "w": plain[name]["w"].cpu()},
                bitwise=False, tol=tol))
        out["four_ranks_" + name] = {
            "backend": "gloo", "rel_err": errs[0], "bitwise_equal_ranks": True,
            "ms_per_round": [run["ms_per_round"] for _, run in runs],
            "ms_median": [run["ms_median"] for _, run in runs],
            "launches": [run["launches"] for _, run in runs],
            "profile": [rec["profile"] for rec, _ in runs]
            if name == "sync" else None}
    out["spawn_s"] = spawn_s

    # (d) the MoE backward: 2 ranks on ("model",), 4 on (data, model)
    job = {"kind": "moe", "ranks": ranks, "store": str(CM_DIR / "store_moe"),
           "out": str(CM_DIR), "timeout_s": spec["timeout_s"]}
    (CM_DIR / "job_moe.json").write_text(json.dumps(job))
    spawn(lambda r: [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--client-mesh-child", str(CM_DIR / "job_moe.json"),
                     str(r)], ranks, timeout_s=spec["timeout_s"])
    moe_out = [json.loads((CM_DIR / f"moe{r}.json").read_text())["moe"]
               for r in range(ranks)]
    for name, members in (("expert", (0, 1)), ("decode", (0, 1, 2, 3))):
        for r in members:
            row = moe_out[r][name]
            check(row["branch"] == name and row["finite"],
                  f"client mesh (d) {name} rank {r}: branch {row['branch']}, "
                  f"finite {row['finite']}")
            worst = max(row["rel_err"].values())
            check(worst <= MOE_GRAD["tol"],
                  f"client mesh (d) {name} rank {r}: gradients "
                  f"{row['rel_err']} > {MOE_GRAD['tol']} of the one-process "
                  f"backward's largest")
    out["moe_backward"] = {
        "arch": MOE_GRAD["arch"], "cut": f"{MOE_GRAD['n_experts']} of 128 "
        "experts, one layer, float32", "tolerance": MOE_GRAD["tol"],
        "ranks": moe_out}
    out["seconds"] = time.perf_counter() - t_phase

    b, c = out["four_ranks_sync"], out["four_ranks_async"]
    per_round = {op: one["launches"][op] / spec["rounds"] for op in CM_KERNELS}
    log(f"[client mesh] FLeNS+ k {SUSY['k']} on SUSY {SUSY['n']:,} x "
        f"{SUSY['dim']} f64 as m {SUSY['m']}, cohort {cohort}, edge channel "
        f"+ comp+sched+ef codecs with EF; launches a round a rank "
        f"{per_round}")
    log(f"[client mesh] (a) 1 NCCL rank: bit-equal to the run without a mesh "
        f"(iterates, losses, bytes, traces, EF); "
        f"{one['ms_median']:.3f} ms a round (median of rounds 2-"
        f"{spec['rounds']}; {one['ms_per_round']:.3f} over all 10, the "
        f"first opening NCCL) against {plain['sync']['ms_median']:.3f} "
        f"({plain['sync']['ms_per_round']:.3f}) without a mesh")
    log(f"[client mesh] (b) {ranks} gloo ranks, {cohort // ranks} clients "
        f"each: " + " / ".join(f"{ms:.3f}" for ms in b["ms_median"])
        + " ms a round a rank (medians; over all rounds "
        + " / ".join(f"{ms:.3f}" for ms in b["ms_per_round"])
        + f") against {plain['sync']['ms_median']:.3f} in one process; "
        f"ranks bit-equal, within {b['rel_err']:.2e} of it")
    log(f"[client mesh] (c) async, {spec['commits']} commits on {ranks} "
        f"ranks: " + " / ".join(f"{ms:.3f}" for ms in c["ms_per_round"])
        + f" ms a commit a rank against "
        f"{plain['async']['ms_per_round']:.3f}; ranks bit-equal, within "
        f"{c['rel_err']:.2e}; launches "
        f"{ {op: c['launches'][0][op] for op in CM_KERNELS} }")
    for label, prof in (("one process", plain_profile),
                        ("1 NCCL rank", one_profile),
                        ("gloo rank 0", b["profile"][0])):
        log(f"[client mesh]   {label}, a profiled one-round run_rounds: "
            f"device busy {prof['busy_share']:.1%} of "
            f"{prof['wall_us'] / 1e3:.3f} ms")
        for r in prof["top"][:5]:
            log(f"[client mesh]     {r['us_per_round']:9.1f} us x"
                f"{r['launches_per_round']:.0f}  {r['kernel']}")
    for name in ("expert", "decode"):
        rows = [moe_out[r][name] for r in range(ranks) if name in moe_out[r]]
        log(f"[client mesh] (d) moe backward {name} branch "
            f"({MOE_GRAD['n_experts']} of 128 arctic experts, f32, "
            f"{len(rows)} ranks): worst relative gradient error "
            f"{max(max(r['rel_err'].values()) for r in rows):.2e} (tol "
            f"{MOE_GRAD['tol']}); ms " + " / ".join(
                f"{r['mesh_ms']:.1f}" for r in rows)
            + f" against {rows[0]['one_process_ms']:.1f} in one process")
    log(f"[client mesh] on {card}; phase 5i took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 6. long rows
# ---------------------------------------------------------------------------

def phase_long_rows() -> dict:
    """The three transforms past the single-pass length, bit-equal to
    their plain versions; fwht and srht_apply timed there."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fwht import kernel_route

    dev = _card()
    cases = [(20000, 1 << 15, 64, (3,)), ((1 << 17) - 5, 1 << 17, 300, (2,)),
             (1 << 20, 1 << 20, 1000, (1,))]
    worst = {name: 0.0 for name in ("fwht", "srht_apply", "srht_apply_t")}
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(2)
        for dim, n, k, batch in cases:
            signs, rows = _operator(gen, n, k, dtype, dev)
            x = torch.randn(batch + (dim,), generator=gen, dtype=dtype,
                            device=dev)
            y = torch.randn(batch + (k,), generator=gen, dtype=dtype,
                            device=dev)
            xp = torch.randn(batch + (n,), generator=gen, dtype=dtype,
                             device=dev)
            pairs = {
                "srht_apply": (ops.srht_apply(x, signs, rows, impl="cuda"),
                               ops.srht_apply(x, signs, rows, impl="ref")),
                "srht_apply_t": (
                    ops.srht_apply_t(y, signs, rows, dim, impl="cuda"),
                    ops.srht_apply_t(y, signs, rows, dim, impl="ref")),
                "fwht": (ops.fwht(xp, normalize=True, impl="cuda"),
                         ops.fwht(xp, normalize=True, impl="ref")),
            }
            torch.cuda.synchronize()
            for name, (got, want) in pairs.items():
                err = _max_err(got, want)
                worst[name] = max(worst[name], err)
                check(torch.equal(got, want),
                      f"{name} {dtype} dim={dim} n={n} k={k}: kernel differs "
                      f"from the plain version (max abs err {err:.3e})")
    # fwht at (64, 2^17) (64 MB in float64) and (1, 2^20), no single
    # PyTorch call computing it (a dense H_n would take 137 GB); srht_apply
    # over two rows of 2^17 - 5 through the long-row path
    timings = []
    gen = torch.Generator(device=dev).manual_seed(4)
    for rows_n, log_n in ((64, 17), (1, 20)):
        n = 1 << log_n
        xp = torch.randn(rows_n, n, generator=gen, dtype=torch.float64, device=dev)
        item = xp.element_size()
        bound, bound_by = _bound_ms(xp.numel() * item, xp.numel() * item,
                                    rows_n * (n * log_n + n), torch.float64)

        def kern(xp=xp):
            return ops.fwht(xp, normalize=True, impl="cuda")

        def plain(xp=xp):
            return ops.fwht(xp, normalize=True, impl="ref")
        got, want = kern(), plain()
        label = f"({rows_n}, 2^{log_n}) f64, two passes"
        check(torch.equal(got, want), f"fwht {label}: kernel differs from "
              f"the plain version (max abs err {_max_err(got, want):.3e})")
        by_kernel = _device_kernels_ms(kern, 20)
        timings.append(dict(
            op="fwht", shape=label, dims=list(xp.shape), n=n,
            route=kernel_route("fwht", n), ms=_time_ms(kern, 20),
            device_ms=sum(by_kernel.values()), device_kernels_ms=by_kernel,
            plain_ms=_time_ms(plain, 5), library_ms=None, bound_ms=bound,
            bound_by=bound_by, max_abs_err=_max_err(got, want)))
        del xp, got, want
    n, k, dim = 1 << 17, 300, (1 << 17) - 5
    signs, rows = _operator(gen, n, k, torch.float64, dev)
    x = torch.randn(2, dim, generator=gen, dtype=torch.float64, device=dev)
    timings.append(dict(op="srht_apply", **_srht_fwd_row(
        "(2, 2^17 - 5) f64 -> k 300", x, signs, rows, None)))
    log(f"[long] {len(cases)} lengths x 2 dtypes x 3 kernels bit-equal to "
        f"the plain versions (max abs err {worst})")
    for r in timings:
        log(f"[long] {r['op']} {r['shape']} {r['ms']:.4f} ms, device "
            f"{r['device_ms']:.4f} (bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}, plain {r['plain_ms']:.4f}); {r['route']}")
        for name, ms in r["device_kernels_ms"].items():
            log(f"[long]   {ms:.4f} ms  {name}")
    return {"max_abs_err": worst, "timings": timings}


# ---------------------------------------------------------------------------
# 7. codec parity
# ---------------------------------------------------------------------------

# (rows, P): the main path's payloads at the SUSY size (h_sk packed by
# sympack, sg, grad, h_sk crushed by top-k, a broadcast), ragged widths,
# the warp routes' limit (32 values a lane) and one past it on the block
# routes, and rows streamed from device memory
CODEC_SHAPES = [(1000, 55), (1000, 10), (1000, 18), (1000, 100), (1, 18),
                (7, 1), (5, 33), (3, 1000), (1000, 1024), (1000, 1025),
                (2, 5000), (4, 1 << 20)]


def _codec_inputs(gen, rows, p, dtype, dev):
    x = torch.randn(rows, p, generator=gen, dtype=dtype, device=dev)
    x = x * 10.0 ** torch.randint(-3, 4, (rows, 1), generator=gen,
                                  device=dev).to(dtype)
    # a tie-heavy row of small integers and an all-zero row
    x[0] = torch.randint(-3, 4, (p,), generator=gen, device=dev).to(dtype)
    if rows > 1:
        x[1] = 0.0
    u = torch.rand(rows, p, generator=gen, dtype=dtype, device=dev)
    return x, u


def phase_codec_parity() -> dict:
    from repro_torch.kernels import ops

    dev = _card()
    worst = {"topk_mask": 0.0, "qint8_roundtrip": 0.0}
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(3)
        for rows, p in CODEC_SHAPES:
            x, u = _codec_inputs(gen, rows, p, dtype, dev)
            pairs = [("qint8_roundtrip",
                      ops.qint8_roundtrip(x, u, impl="cuda"),
                      ops.qint8_roundtrip(x, u, impl="ref"))]
            for kept in sorted({1, max(1, p // 10), max(1, p // 2), p}):
                pairs.append(("topk_mask", ops.topk_mask(x, kept, impl="cuda"),
                              ops.topk_mask(x, kept, impl="ref")))
            torch.cuda.synchronize()
            for name, got, want in pairs:
                err = _max_err(got, want)
                worst[name] = max(worst[name], err)
                check(torch.equal(got, want),
                      f"{name} {dtype} ({rows}, {p}): kernel differs from "
                      f"the plain version (max abs err {err:.3e})")
    log(f"[codec] {len(CODEC_SHAPES)} shapes x 2 dtypes bit-equal to the "
        f"plain versions (max abs err {worst})")
    return worst


# ---------------------------------------------------------------------------
# 8. transport at full size
# ---------------------------------------------------------------------------

def _edge_channel(m: int):
    """examples/edge_clients.py:81-91: log-spaced uplinks from 30 kB/s to
    3 MB/s, 10x downlinks, 80 ms latency, 20% stragglers x10, 10% drop."""
    from repro_torch.comm import ChannelModel

    rates = torch.logspace(math.log10(3e4), math.log10(3e6), m,
                           dtype=torch.float64).numpy()
    return ChannelModel(uplink_bytes_per_s=rates,
                        downlink_bytes_per_s=10.0 * rates, latency_s=0.08,
                        straggler_prob=0.20, straggler_slowdown=10.0,
                        dropout_prob=0.10)


def _codec_launches_per_round(cfg, uplinks) -> dict:
    """The codec kernels one round launches, read off the codec chain of
    each uplink payload (every stage is one batched launch; downlinks
    are identity here)."""
    from repro_torch.comm import QInt8Codec, TopKCodec

    counts = dict(NO_CODEC)
    for name in uplinks:
        codec = cfg.codec_for(name)
        while codec is not None:
            if isinstance(codec, TopKCodec):
                counts["topk_mask"] += 1
            if isinstance(codec, QInt8Codec):
                counts["qint8_roundtrip"] += 1
            codec = getattr(codec, "inner", None)
    return counts


def _transport_run(problem, w0, w_star, sketch, cfg, rounds, impl=None):
    from repro_torch.core import FLeNS, run_rounds
    from repro_torch.kernels import ops

    class GuardedFLeNS(FLeNS):
        """FLeNS+ that notes the server's guarded loss before each round."""

        guarded: list

        def round_signature(self, round_idx, state):
            self.guarded.append(float(state["loss"]))
            return super().round_signature(round_idx, state)

    opt = GuardedFLeNS(k=SUSY["k"], variant="plus", sketch=sketch)
    opt.guarded = []
    with ops.use_impl(impl):
        hist = run_rounds(opt, problem, w0, w_star, rounds=rounds, comm=cfg)
    return opt, hist


def _codec_host_path(x, u) -> dict:
    """Host microseconds per call of each step of the launch path of
    ``ops.qint8_roundtrip(..., impl="cuda")``, each step timed alone;
    beside them the steps the parent commit took otherwise (checks by
    torch.device, tiny from torch.finfo, the entry point by an f-string
    on a ctypes library, the ctypes call)."""
    import ctypes

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import codec as kcodec
    from repro_torch.kernels import fwht as kfwht

    suffix = kfwht.check_input(x, "x")
    entry = kcodec._entry("qint8_roundtrip", suffix)
    out = torch.empty_like(x)
    rows, p = kcodec._rows(x)
    tiny = kcodec._TINY[x.dtype]
    args = (x.data_ptr(), u.data_ptr(), out.data_ptr(), rows, p, tiny,
            kfwht.stream_of(x))
    lib = ctypes.CDLL(_build.module("codec").__file__)
    by_ctypes = getattr(lib, f"repro_qint8_roundtrip_{suffix}")
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    by_ctypes.argtypes = [ptr, ptr, ptr, ll, ll, ctypes.c_double, ptr]
    by_ctypes.restype = ctypes.c_int

    def guard():
        with kfwht.device_guard(x):
            pass
    path = {
        "dispatch (resolve_impl, get_impl)":
            lambda: ops.get_impl("qint8_roundtrip",
                                 ops.resolve_impl("cuda", x), x),
        "checks (check_input x2, attributes, _rows)":
            lambda: (kfwht.check_input(x, "x"), kfwht.check_input(u, "u"),
                     u.dtype != x.dtype or u.get_device() != x.get_device()
                     or u.shape != x.shape, kcodec._rows(x)),
        "output (empty_like)": lambda: torch.empty_like(x),
        "entry point (_entry)":
            lambda: kcodec._entry("qint8_roundtrip", suffix),
        "tiny (cached)": lambda: kcodec._TINY[x.dtype],
        "device guard (device_guard)": guard,
        "stream (stream_of)": lambda: kfwht.stream_of(x),
        "launch (extension call)": lambda: entry(*args),
    }
    parent = {
        "checks by torch.device":
            lambda: (u.dtype != x.dtype or u.device != x.device
                     or u.shape != x.shape),
        "tiny (torch.finfo)": lambda: float(torch.finfo(x.dtype).tiny),
        "entry point (f-string getattr on ctypes)":
            lambda: getattr(lib, f"repro_qint8_roundtrip_{suffix}"),
        "launch (ctypes call)": lambda: by_ctypes(*args),
    }
    steps = {name: _host_us(fn) for name, fn in path.items()}
    return {"steps_us": steps, "steps_sum_us": sum(steps.values()),
            "call_us": _host_us(lambda: ops.qint8_roundtrip(x, u,
                                                            impl="cuda")),
            "parent_steps_us": {name: _host_us(fn)
                                for name, fn in parent.items()},
            "reps": HOST_REPS}


def _codec_timings(dev) -> dict:
    """Each codec kernel at its main-path shapes (and one wide shape that
    is not on the path), beside its bound, the plain version and, for
    top-k, torch.topk + scatter; events and the profiler's device time,
    the kernel that serves each shape, and the host path of
    qint8_roundtrip at its first shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.codec import codec_route

    gen = torch.Generator(device=dev).manual_seed(4)
    calls = {"topk_mask": [("h_sk crushed (m, k*k)", (1000, 100), 25),
                           ("grad (m, M)", (1000, 18), 2),
                           ("sg crushed (m, k)", (1000, 10), 5),
                           ("not a main-path shape", (1000, 16384), 1639)],
             "qint8_roundtrip": [("h_sk packed (m, k(k+1)/2)", (1000, 55), 0),
                                 ("grad (m, M)", (1000, 18), 0),
                                 ("sg (m, k)", (1000, 10), 0),
                                 ("not a main-path shape", (1000, 16384), 0)]}
    out = {}
    for name, shapes in calls.items():
        rows_out = []
        for label, (rows, p), kept in shapes:
            x, u = _codec_inputs(gen, rows, p, torch.float64, dev)
            item = x.element_size()
            if name == "topk_mask":
                def kern(x=x, kept=kept):
                    return ops.topk_mask(x, kept, impl="cuda")

                def plain(x=x, kept=kept):
                    return ops.topk_mask(x, kept, impl="ref")

                def lib(x=x, kept=kept):
                    idx = torch.topk(x.abs(), kept, dim=1).indices
                    return torch.zeros_like(x).scatter_(1, idx,
                                                        x.gather(1, idx))
                read, count = x.numel() * item, x.numel() * (item + 2)
            else:
                def kern(x=x, u=u):
                    return ops.qint8_roundtrip(x, u, impl="cuda")

                def plain(x=x, u=u):
                    return ops.qint8_roundtrip(x, u, impl="ref")
                lib = None
                read, count = 2 * x.numel() * item, 7 * x.numel()
            bound, bound_by = _bound_ms(read, x.numel() * item, count,
                                        torch.float64)
            row = dict(
                shape=label, dims=[rows, p], kept=kept or None,
                route=codec_route(name, p, x.dtype),
                ms=_time_ms(kern, 200), device_ms=_device_ms(kern, 200),
                plain_ms=_time_ms(plain, 50),
                library_ms=None if lib is None else _time_ms(lib, 200),
                library_device_ms=(None if lib is None
                                   else _device_ms(lib, 200)),
                library="torch.topk + scatter" if lib else "none",
                bound_ms=bound, bound_by=bound_by,
                max_abs_err=_max_err(kern(), plain()))
            if name == "qint8_roundtrip" and not rows_out:
                row["host_path"] = _codec_host_path(x, u)
            rows_out.append(row)
        out[name] = rows_out
    return out


def _bare_ms(step, rounds: int = 10) -> list:
    """Host clock around each of ``rounds`` steps that end in a
    synchronize, after one warm step."""
    step()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t1) * 1e3)
    return out


def _bare_transport_rounds(problem, w0, chan) -> dict:
    """FLeNS+ bare rounds (no per-round evaluation) without a transport
    and under comp+sched+ef, and a profile of three transport rounds."""
    from repro_torch.comm import CommConfig, make_session
    from repro_torch.core import FLeNS
    from repro_torch.core.base import build_round, root_key, split

    dev = problem.X.device
    sketch, codecs, _ = TRANSPORTS["comp+sched+ef"]
    opt = FLeNS(k=SUSY["k"], variant="plus", sketch=sketch)
    state = opt.init(problem, w0)
    keys = iter(split(root_key(9, device=dev), 32))

    def plain_step():
        nonlocal state
        state = opt.round(problem, state, next(keys))
    none_ms = _bare_ms(plain_step)
    cfg = CommConfig(codecs=codecs, channel=chan, scheduler="bandwidth:0.5",
                     error_feedback=True, seed=1)
    session = make_session(cfg, m=problem.m,
                           keys=split(root_key(10, device=dev), 32),
                           state0=opt.init(problem, w0),
                           mask_dtype=problem.X.dtype, device=dev)
    session.begin_variant(None)
    fn = build_round(opt, problem, session)
    comm_ms = _bare_ms(lambda: session.step(fn))
    profile = _profile_steps(lambda: session.step(fn), 3)
    med = sorted(none_ms)[len(none_ms) // 2], sorted(comm_ms)[len(comm_ms) // 2]
    log(f"[transport] bare FLeNS+ rounds: {med[0]:.2f} ms median without a "
        f"transport, {med[1]:.2f} ms under comp+sched+ef; profile of 3 "
        f"transport rounds: device busy {profile['busy_share']:.1%} of "
        f"{profile['wall_us'] / 3e3:.2f} ms/round")
    for r in profile["top"]:
        log(f"[transport]   {r['us_per_round']:9.1f} us/round x"
            f"{r['launches_per_round']:.0f}  {r['kernel']}")
    return {"no_transport_ms": none_ms, "comp_sched_ef_ms": comm_ms,
            "profile": profile}


def phase_transport(problem, w0, w_star) -> dict:
    from repro_torch.comm import CommConfig
    from repro_torch.kernels import ops

    dev = _card()
    rounds = 10
    chan = _edge_channel(problem.m)
    uplinks = ("h_sk", "sg", "grad", "loss")  # FLeNS+ with the guard
    out = {"rounds": rounds, "runs": {}}
    launches = dict(NO_CODEC)
    for name, (sketch, codecs, up_bytes) in TRANSPORTS.items():
        cfg = CommConfig(codecs=codecs, channel=chan,
                         scheduler="bandwidth:0.5", error_feedback=True,
                         seed=1)
        per_round = _codec_launches_per_round(cfg, uplinks)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        opt, hist = _transport_run(problem, w0, w_star, sketch, cfg, rounds)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        want = {"fwht": 0, "srht_apply": 4 * rounds,
                "srht_apply_t": 3 * rounds, **NO_ROWS, **NO_LM,
                **{op: n * rounds for op, n in per_round.items()}}
        check(counts == want, f"{name} launches {counts} != {want}")
        for op in NO_CODEC:
            launches[op] += counts[op]
        guarded = opt.guarded
        check(all(math.isfinite(v) for v in guarded)
              and bool(torch.isfinite(torch.as_tensor(hist.loss)).all()),
              f"{name}: non-finite loss")
        check(all(b <= a for a, b in zip(guarded, guarded[1:])),
              f"{name}: the guarded loss rose: {guarded}")
        check(hist.loss[-1] < hist.loss[0], f"{name}: the loss did not fall")
        delivered_bytes = {float(v) for tr in hist.traces
                           for v in tr.bytes_up if v}
        check(delivered_bytes == {float(up_bytes)},
              f"{name}: uplink bytes per delivering client "
              f"{delivered_bytes} != {up_bytes}")
        _, plain = _transport_run(problem, w0, w_star, sketch, cfg, rounds,
                                  impl="ref")
        check((hist.loss == plain.loss).all()
              and (hist.cumulative_bytes == plain.cumulative_bytes).all()
              and (hist.sim_time_s == plain.sim_time_s).all(),
              f"{name}: the run through the kernels ({hist.loss.tolist()}) "
              f"differs from the run through the plain versions "
              f"({plain.loss.tolist()})")
        per_round_bytes = [float(b) for b in
                           hist.cumulative_bytes[1:] - hist.cumulative_bytes[:-1]]
        run = {"sketch": sketch, "codecs": codecs,
               "launches": counts, "codec_launches_per_round": per_round,
               "loss": hist.loss.tolist(), "gap": hist.gap.tolist(),
               "guarded_loss": guarded,
               "uplink_bytes_per_delivering_client": up_bytes,
               "bytes_per_round": per_round_bytes,
               "sim_time_s": float(hist.sim_time_s[-1]),
               "ms_per_round": hist.wall_time_s * 1e3 / rounds,
               "plain_ms_per_round": plain.wall_time_s * 1e3 / rounds,
               "peak_memory_bytes": peak,
               "ef_residuals": hist.ef_residuals,
               "delivered_per_round": [int(tr.delivered.sum())
                                       for tr in hist.traces]}
        out["runs"][name] = run
        log(f"[transport] {name} ({sketch}): gap "
            + " ".join(f"{g:.3e}" for g in hist.gap))
        log(f"[transport] {name}: launches {counts}; {up_bytes} B up per "
            f"delivering client, {sum(per_round_bytes) / rounds:.0f} B per "
            f"round; {run['sim_time_s']:.2f} simulated s; "
            f"{run['ms_per_round']:.2f} ms per round "
            f"(plain versions {run['plain_ms_per_round']:.2f}); peak memory "
            f"{peak / 2**30:.2f} GiB; same trajectory through the plain "
            f"versions")
    out["launches"] = launches
    out["bare"] = _bare_transport_rounds(problem, w0, chan)
    out["kernels"] = _codec_timings(dev)
    for name, rows in out["kernels"].items():
        for r in rows:
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}, device "
                        f"{r['library_device_ms']:.4f} ({r['library']})")
            log(f"[transport] {name:<15} {r['shape']:<28} {r['dims']} "
                f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} "
                f"[{r['route']}] (bound {r['bound_ms']:.6f} by "
                f"{r['bound_by']}, plain {r['plain_ms']:.4f}, library {lib})")
    host = out["kernels"]["qint8_roundtrip"][0]["host_path"]
    log(f"[transport] qint8_roundtrip (1000, 55) host path, us a call over "
        f"{host['reps']} calls: whole call {host['call_us']:.2f}; "
        + ", ".join(f"{k} {v:.2f}" for k, v in host["steps_us"].items())
        + "; the parent's way: "
        + ", ".join(f"{k} {v:.2f}" for k, v in host["parent_steps_us"].items()))
    return out


# ---------------------------------------------------------------------------
# 9. flash parity
# ---------------------------------------------------------------------------

# the flash kernels against their plain version: (tq, tk) x (H, Hkv) x D
# in both dtypes (q_offset = tk - tq keeps causal rows non-empty), then
# windows, non-causal, q_offset with a window, and rows that see no key;
# bfloat16 takes the wgmma kernel, float32 the 3xTF32 kernel
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_ROUTE = {torch.float32: "tf32x3", torch.bfloat16: "sm90"}
FLASH_SHAPES = [(64, 64), (100, 100), (32, 96), (1, 128), (2048, 2048)]
FLASH_HEADS = [(4, 4), (8, 1), (32, 4)]
FLASH_EXTRA = [  # (tq, tk, H, Hkv, D, causal, window, q_offset, block_k)
    (100, 100, 4, 4, 64, True, 1, 0, 1024),
    (100, 100, 8, 1, 128, True, 7, 0, 1024),
    (100, 100, 8, 1, 112, True, 7, 0, 64),
    (2048, 2048, 4, 1, 256, True, 512, 0, 1024),
    (2048, 2048, 16, 2, 128, True, 512, 0, 1024),
    (2048, 2048, 8, 2, 256, True, 128, 0, 1024),
    # recurrentgemma's local attention: 10 query heads on one KV head
    (2048, 2048, 10, 1, 256, True, 2048, 0, 1024),
    (100, 100, 10, 1, 256, True, 32, 0, 1024),
    (64, 48, 4, 4, 64, False, None, 0, 1024),
    (48, 200, 4, 2, 64, False, 16, 70, 32),
    (32, 96, 8, 2, 64, True, 20, 500, 1024),
    (4, 8, 1, 1, 8, True, 2, 20, 4),  # no row sees a key
    (64, 200, 8, 2, 64, True, 16, 300, 64),  # no row sees a key, ragged tk
    # whisper's encoder: non-causal over 1500 frames (23 key tiles of 64
    # and a ragged one of 28)
    (1500, 1500, 6, 6, 64, False, None, 0, 1024),
    (4096, 4096, 4, 1, 64, True, None, 0, 1024),  # rows of up to 8192 keys
    (8192, 8192, 4, 1, 64, True, None, 0, 1024),
    (8192, 8192, 4, 1, 128, True, None, 0, 1024),
    # gemma3-4b's heads at 8192 keys: its local window and causal
    (8192, 8192, 8, 4, 256, True, 1024, 0, 1024),
    (8192, 8192, 8, 4, 256, True, None, 0, 1024),
]
# head dims that are not a multiple of 8, in both dtypes: the tf32x3
# kernel (bf16 D 200 would take the sm90 kernel and is left out)
FLASH_ODD_D = [(100, 100, 4, 2, 12, True, None, 0, 1024),
               (70, 90, 2, 1, 13, True, None, 20, 1024)]
FLASH_ODD_D_F32 = [(130, 130, 4, 1, 200, True, 48, 0, 1024)]


def _flash_inputs(gen, b, tq, tk, h, hkv, d, dtype, dev):
    q = torch.randn(b, tq, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, tk, hkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, tk, hkv, d, generator=gen, device=dev).to(dtype)
    return q, k, v


def phase_flash_parity() -> dict:
    from repro_torch.kernels import ops

    dev = _card()
    cases = []
    for tq, tk in FLASH_SHAPES:
        for h, hkv in FLASH_HEADS:
            for d in (64, 128, 256):
                cases.append((tq, tk, h, hkv, d, True, None, tk - tq, 1024))
    cases += FLASH_EXTRA
    worst = {"sm90 bfloat16": 0.0, "tf32x3 float32": 0.0,
             "tf32x3 bfloat16": 0.0}
    rows = []
    for dtype, tol in FLASH_TOL.items():
        gen = torch.Generator(device=dev).manual_seed(5)
        route = FLASH_ROUTE[dtype]
        extra = FLASH_ODD_D + (FLASH_ODD_D_F32 if dtype == torch.float32
                               else [])
        ops.reset_launch_counts()
        for i, (tq, tk, h, hkv, d, causal, window, q_offset,
                block_k) in enumerate(cases + extra):
            q, k, v = _flash_inputs(gen, 2 if tq < 2048 else 1, tq, tk, h,
                                    hkv, d, dtype, dev)
            kw = dict(causal=causal, window=window, q_offset=q_offset,
                      block_k=block_k)
            got = ops.flash_attention(q, k, v, impl="cuda", **kw)
            want = ops.flash_attention(q, k, v, impl="ref", **kw)
            torch.cuda.synchronize()
            err = _max_err(got.float(), want.float())
            name = str(dtype).split(".")[-1]
            on = route if i < len(cases) else "tf32x3"
            worst[f"{on} {name}"] = max(worst[f"{on} {name}"], err)
            label = (f"{name} tq={tq} tk={tk} H={h} Hkv={hkv} D={d} "
                     f"causal={causal} window={window} q_offset={q_offset} "
                     f"block_k={block_k}")
            rows.append({"case": label, "route": on, "max_abs_err": err})
            log(f"[flash parity] {label} ({on}): max abs err {err:.3e}")
            check(got.dtype == dtype and err <= tol,
                  f"flash_attention {label}: kernel differs from the plain "
                  f"version by {err:.3e} > {tol}")
        counts = ops.launch_counts()
        want_routes = {"sm90": 0, "tf32x3": 0}
        want_routes[route] += len(cases)
        want_routes["tf32x3"] += len(extra)
        got_routes = {r: counts[f"flash_attention_{r}"] for r in want_routes}
        check(got_routes == want_routes,
              f"flash parity {name}: launches by route {got_routes} != "
              f"{want_routes}")
    log(f"[flash parity] {len(cases)} cases x 2 dtypes (+ "
        f"{len(FLASH_ODD_D) + len(FLASH_ODD_D_F32)} f32 and "
        f"{len(FLASH_ODD_D)} bf16 head dims not a multiple of 8 on the "
        f"tf32x3 kernel) within float32 "
        f"{FLASH_TOL[torch.float32]}, bfloat16 {FLASH_TOL[torch.bfloat16]}; "
        f"each on its route (worst {worst})")
    return {"worst": worst, "cases": rows}


# ---------------------------------------------------------------------------
# 10. serve: TinyLlama-1.1B through the continuous-batching engine
# ---------------------------------------------------------------------------

SERVE = dict(arch="tinyllama-1.1b", max_batch=4, cache_len=4096, requests=8,
             min_prompt=100, max_prompt=2000, new_tokens=64)
BF16_ULPS = 4  # bf16 prefill logits: kernel vs plain within 4 ulps of max|logit|
F32_LOGIT_TOL = 1e-3


def _serve_requests(vocab: int, new_tokens: "int | None" = None,
                    spec: dict = SERVE):
    """``spec``'s requests (its count and prompt lengths; SERVE's by
    default), from seed 0."""
    import numpy as np
    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    lengths = rng.integers(spec["min_prompt"], spec["max_prompt"] + 1,
                           spec["requests"])
    return [Request(uid=i, prompt=[int(t) for t in
                                   rng.integers(0, vocab, int(n))],
                    max_new_tokens=new_tokens or SERVE["new_tokens"])
            for i, n in enumerate(lengths)]


def _serve_model(dtype, arch=SERVE["arch"], n_layers=None, **cuts):
    """(cfg, model, params from seed 0 on the card, init seconds): the
    config in ``dtype`` with its depth cut to ``n_layers`` where given
    and any other field replaced by ``cuts`` (every cut is listed by
    ``_cut_list``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.base import root_key
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_config(arch), dtype=dtype,
                              param_dtype=dtype, **cuts)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(root_key(0, device=torch.device("cuda", 0)))
    torch.cuda.synchronize()
    return cfg, model, params, time.perf_counter() - t0


def _cut_list(cfg) -> list:
    """How ``cfg`` was cut from its published config: each field that
    differs (the dtypes and the cache mode, a variant, aside), as "field
    published -> run"."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(cfg.arch_id)
    return [f"{f.name} {getattr(full, f.name)} -> {getattr(cfg, f.name)}"
            for f in dataclasses.fields(cfg)
            if f.name not in ("dtype", "param_dtype", "cache_mode")
            and getattr(full, f.name) != getattr(cfg, f.name)]


def _run_engine(model, params, reqs, cache_len=SERVE["cache_len"],
                max_batch=SERVE["max_batch"]) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(model, params, max_batch=max_batch,
                           cache_len=cache_len)
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    steps = 0
    while engine.queue or engine.active.any():
        engine.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(all(r.done for r in reqs), "serve: a request did not complete")
    generated = sum(len(r.generated) for r in reqs)
    return {"engine": engine, "launches": counts, "wall_s": wall,
            "steps": steps, "generated_tokens": generated,
            "tokens_per_s": generated / wall}


def _prefill_routed(model, params, tokens, impl=None):
    """A prefill's last-position logits in float32 and the routing of its
    moe layers (``moe.record_routes``; none without a moe group)."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe

    with ops.use_impl(impl), moe.record_routes() as routes:
        logits, _ = model.prefill(params, {"inputs": tokens},
                                  cache_len=tokens.shape[1])
    return logits.float(), routes


def _route_flips(routes: list, want: list) -> dict:
    """The (token, slot) expert choices and keeps on which two runs'
    recorded routes differ, over every moe layer: a choice that flips
    between the kernel and the plain version moves an output by far more
    than the kernel's tolerance, so a logits comparison holds only where
    none flips."""
    check(len(routes) == len(want), f"moe calls {len(routes)} != "
          f"{len(want)}")
    return {"choices": sum(int((a["ids"] != b["ids"]).sum())
                           for a, b in zip(routes, want)),
            "keeps": sum(int((a["keep"] != b["keep"]).sum())
                         for a, b in zip(routes, want)),
            "assignments": sum(a["ids"].numel() for a in routes)}


def _attention_layer_errs(model, params, tokens) -> list:
    """Each attention layer of a prefill of ``tokens`` through the
    kernels: the flash kernel against its plain version on the layer's
    own q, k and v (max abs error, one a layer), so the kernel is held
    on identical inputs where a route flip upstream makes the model's
    outputs incomparable."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.common import embed, rmsnorm

    cfg = model.cfg
    x = embed(params["embed"], tokens, cfg)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    errs = []
    for gi, g in enumerate(model.groups):
        check(g.kind in ("dense", "moe"), f"no layer walk for {g.kind}")
        for i in range(g.n):
            p = lm_mod._layer(params[f"group{gi}"], i)
            q, k, v = attn._qkv(p["attn"], rmsnorm(p["ln1"], x), cfg)
            q = attn.rope(q, pos, g.thetas[i])
            k = attn.rope(k, pos, g.thetas[i]).contiguous()
            got, want = (ops.flash_attention(q, k, v.contiguous(),
                                             window=g.windows[i], impl=impl)
                         for impl in (None, "ref"))
            errs.append(_max_err(got.float(), want.float()))
            unit = (lm_mod._dense_unit_apply if g.kind == "dense"
                    else lm_mod._moe_unit_apply)
            x = unit(p, x, cfg, window=g.windows[i], theta=g.thetas[i])[0]
    return errs


def _hold_kernel_in_prefill(model, params, tokens, got, routes, tol_of,
                            label: str) -> dict:
    """The 2048-token prefill through the kernels (``got``, ``routes``)
    against the plain version's: the route flips between the two, the
    logits held within ``tol_of(max |logit|)`` where none flips; for a
    model with moe layers, every attention layer's kernel against its
    plain version on identical inputs (``FLASH_TOL``), and each moe
    layer's drop fraction."""
    want, want_routes = _prefill_routed(model, params, tokens, impl="ref")
    err = _max_err(got, want)
    tol = tol_of(float(want.abs().max()))
    flips = _route_flips(routes, want_routes)
    flipped = flips["choices"] or flips["keeps"]
    agree = bool((got.argmax(-1) == want.argmax(-1)).all())
    out = {"max_abs_err": err, "tolerance": tol,
           "max_abs_logit": float(want.abs().max()), "argmax_equal": agree,
           "route_flips": flips}
    if routes:
        out["drop_frac_by_layer"] = [float(r["drop_frac"]) for r in routes]
        out["capacity"] = routes[0]["capacity"]
        errs = _attention_layer_errs(model, params, tokens)
        flash_tol = FLASH_TOL[model.cfg.dtype]
        out["attention_by_layer"] = {"max_abs_err": errs,
                                     "tolerance": flash_tol}
        log(f"{label}: {flips['choices']} of {flips['assignments']} expert "
            f"choices and {flips['keeps']} keeps differ between the kernel's "
            f"and the plain version's routes; drop fraction by moe layer "
            f"{out['drop_frac_by_layer']} (capacity {out['capacity']}); "
            f"attention kernel vs plain on each layer's own q, k, v: max "
            f"abs err {[f'{e:.3e}' for e in errs]} (tolerance {flash_tol})")
        check(max(errs) <= flash_tol, f"{label}: an attention layer's kernel "
              f"differs from its plain version by {max(errs):.3e} > "
              f"{flash_tol} on identical inputs")
    log(f"{label}: logits kernel vs plain max abs err {err:.4e} (tolerance "
        f"{tol:.4e}, max |logit| {out['max_abs_logit']:.3f}); argmax equal: "
        f"{agree}" + ("; routes flipped, so the logits are held by the "
                      "layers' attention instead" if flipped else ""))
    if not flipped:
        check(err <= tol, f"{label}: prefill logits through the kernel differ "
              f"from the plain version by {err:.4e} > {tol:.4e}")
    return out


def _profile_call(fn, ranges=()) -> dict:
    """One profiled call of ``fn``: its wall and device busy time, the
    flash forward's device time and the flash backward's, the top kernels
    and the host ops of most self time (where an idle device waits), and
    under ``ranges_us`` the device-side span of each of ``ranges``
    (``torch.profiler.record_function`` names: from its first kernel's
    start to its last kernel's end, summed over its calls; the device's
    idle gaps inside it included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # a record_function range shows as a device-side annotation too: its
    # time is its kernels', so it is read apart and not counted twice
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key not in ranges]
    busy = sum(t for _, t, _ in kernels)
    # flash_attention_sm90_kernel<...> in bf16, flash_attention_tf32x3_kernel<...> in f32
    flash = sum(t for name, t, _ in kernels if "flash_attention" in name)
    # flash_bwd_{delta,dkdv,sum,dq}_{tf32x3,sm90}_kernel<...>
    flash_bwd = sum(t for name, t, _ in kernels if "flash_bwd" in name)
    top = sorted(kernels, key=lambda r: -r[1])[:8]
    host = sorted(((e.key, e.self_cpu_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])
    return {"wall_us": wall_us, "device_busy_us": busy,
            "host_self_us": sum(t for _, t, _ in host),
            "host_top": [{"op": n[:90], "us": t, "calls": c}
                         for n, t, c in host[:8]],
            "busy_share": busy / wall_us, "flash_us": flash,
            "flash_bwd_us": flash_bwd,
            "flash_share_of_device": flash / busy if busy else 0.0,
            "flash_share_of_wall": flash / wall_us,
            "top": [{"kernel": n[:90], "us": t, "launches": c}
                    for n, t, c in top],
            "ranges_us": {name: sum(e.self_device_time_total
                                    for e in prof.key_averages()
                                    if e.key == name
                                    and e.device_type == DeviceType.CUDA)
                          for name in ranges}}


def _prefill_profile(model, params, tokens) -> dict:
    return _profile_call(lambda: model.prefill(
        params, {"inputs": tokens}, cache_len=tokens.shape[1]))


def _attn_layers(model) -> int:
    """Layers whose attention launches the flash kernel in a prefill: every
    dense and moe layer, one a griffin super-block, local_per_global + 1 a
    dense_sb super-block, a vlm super-block's self layers, whisper's
    decoder and encoder layers; none in mamba2."""
    per = model.cfg.local_per_global
    if model.cfg.family in ("vlm", "audio"):
        return sum(_cross_attn_layers(model))
    return sum(g.n * (per + 1 if g.kind == "dense_sb" else 1)
               for g in model.groups
               if g.kind in ("dense", "dense_sb", "moe", "griffin"))


def _flash_want(n: int, route: str) -> dict:
    return {**NO_LM, "flash_attention": n, f"flash_attention_{route}": n}


def _serve_bf16(arch: str, tag: str, seed: int, n_layers=None,
                new_tokens: "int | None" = None) -> dict:
    """One model at full width in bf16 (random weights from seed 0), at
    full depth or cut to ``n_layers`` (the cut in the record): SERVE's
    requests (each of ``new_tokens`` new tokens, SERVE's where None)
    through the engine, prefill by bucket, decode at batch 4,
    the kernel against the plain version on a 2048-token prefill (where
    the model has attention; ``_hold_kernel_in_prefill``), and a profile
    of that prefill."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import _bucket

    dev = _card()
    torch.cuda.empty_cache()
    cfg, model, params, init_s = _serve_model(torch.bfloat16, arch, n_layers)
    L, n_attn = cfg.n_layers, _attn_layers(model)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"arch": cfg.arch_id, "n_layers": L, "d_model": cfg.d_model,
           "groups": [(g.kind, g.n) for g in model.groups],
           "cuts": _cut_list(cfg), "dtype": "bfloat16", "init_s": init_s}
    with torch.no_grad():
        # warm: first use of every matmul shape of a prefill and a decode
        warm = torch.randint(0, cfg.vocab, (1, 128), generator=gen, device=dev)
        model.prefill(params, {"inputs": warm}, cache_len=256)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        reqs = _serve_requests(cfg.vocab, new_tokens)
        new_tokens = reqs[0].max_new_tokens
        run = _run_engine(model, params, reqs)
        engine = run.pop("engine")
        peak = torch.cuda.max_memory_allocated()
        # a dense model's prompt is padded to its bucket; a recurrent or
        # right-sized one's is not, its chunk-multiple prefix is prefilled
        prefilled = [engine._exact_prefix(len(r.prompt))
                     if model.exact_prefill
                     else min(_bucket(len(r.prompt)), SERVE["cache_len"])
                     for r in reqs]
        want = {op: 0 for op in run["launches"]}
        want.update(_flash_want(n_attn * len(reqs), "sm90"))
        check(run["launches"] == want,
              f"{tag} {arch}: launches {run['launches']} != {want} (one "
              f"launch of the tensor-core kernel per attention layer per "
              f"prefill)")
        check(all(len(r.generated) == new_tokens for r in reqs),
              f"{tag} {arch}: a request stopped short of max_new_tokens")

        # decode at batch 4 on the engine's state: no kernel launch
        state = engine.state
        state["index"] = torch.tensor([2000, 1500, 1000, 500],
                                      dtype=torch.int32, device=dev)
        toks = torch.randint(0, cfg.vocab, (4, 1), generator=gen, device=dev)
        ops.reset_launch_counts()

        def decode():
            nonlocal state
            _, state = model.decode_step(params, state, toks)
        decode_ms = _bare_ms(decode, 20)
        check(ops.launch_counts()["flash_attention"] == 0,
              f"{tag} {arch}: decode launched the flash kernel")
        decode_profile = _profile_steps(decode, 3)
        del engine, state

        # every bucket the request lengths can reach (128..2048)
        prefill_ms = {}
        for b in (128, 256, 512, 1024, 2048):
            tokens = torch.randint(0, cfg.vocab, (1, b), generator=gen,
                                   device=dev)
            ms = _bare_ms(lambda: model.prefill(
                params, {"inputs": tokens}, cache_len=SERVE["cache_len"]), 3)
            prefill_ms[b] = sorted(ms)[1]

        tokens = torch.randint(0, cfg.vocab, (1, 2048), generator=gen,
                               device=dev)
        ops.reset_launch_counts()
        got, routes = _prefill_routed(model, params, tokens)
        check(ops.launch_counts() == {**want, **_flash_want(n_attn, "sm90")},
              f"{tag} {arch}: a 2048-token prefill launched "
              f"{ops.launch_counts()}")
        check(got.shape == (1, cfg.vocab) and bool(torch.isfinite(got).all()),
              f"{tag} {arch}: prefill logits not finite or misshapen")
        if n_attn:
            # BF16_ULPS bf16 ulps of the largest |logit|
            out["logits_2048"] = _hold_kernel_in_prefill(
                model, params, tokens, got, routes,
                lambda top: BF16_ULPS * 2.0 ** (math.floor(math.log2(top))
                                                - 7),
                f"[{tag}] {arch} 2048-token prefill")
        profile = _prefill_profile(model, params, tokens)

    out.update(run)
    out.update({
        "prompt_lengths": [len(r.prompt) for r in reqs],
        "prefilled": prefilled, "peak_memory_bytes": peak,
        "decode_ms_batch4": decode_ms, "decode_profile": decode_profile,
        "prefill_ms_by_bucket": prefill_ms,
        "prefill_tokens_per_s_by_bucket":
            {b: b / ms * 1e3 for b, ms in prefill_ms.items()},
        "prefill_2048_profile": profile})
    med = sorted(decode_ms)[len(decode_ms) // 2]
    log(f"[{tag}] {arch} bf16, {L} layers {out['groups']}, d "
        f"{cfg.d_model}, cut {out['cuts'] or 'none'}: init {init_s:.2f} s; "
        f"engine "
        f"{run['generated_tokens']} tokens for {len(reqs)} requests (prompts "
        f"{out['prompt_lengths']}, prefilled {prefilled}) in "
        f"{run['wall_s']:.3f} s, {run['steps']} steps, "
        f"{run['tokens_per_s']:.1f} tokens/s; launches "
        f"{ {k: v for k, v in run['launches'].items() if v} }; peak memory "
        f"{peak / 2**30:.3f} GiB")
    log(f"[{tag}] {arch} decode at batch 4: {med:.3f} ms per step median "
        f"({min(decode_ms):.3f}..{max(decode_ms):.3f}); profile of 3 steps: "
        f"device busy {decode_profile['busy_share']:.1%} of "
        f"{decode_profile['wall_us'] / 3e3:.3f} ms/step")
    for r in decode_profile["top"][:6]:
        log(f"[{tag}]   {r['us_per_round']:9.1f} us/step x"
            f"{r['launches_per_round']:.0f}  {r['kernel']}")
    for b, ms in prefill_ms.items():
        log(f"[{tag}] {arch} prefill {b:5d} tokens: {ms:.3f} ms "
            f"({b / ms * 1e3:,.0f} tokens/s)")
    log(f"[{tag}] {arch} profile of a 2048-token prefill: device busy "
        f"{profile['device_busy_us'] / 1e3:.3f} ms = "
        f"{profile['busy_share']:.1%} of wall {profile['wall_us'] / 1e3:.3f} "
        f"ms; flash kernel {profile['flash_us'] / 1e3:.3f} ms = "
        f"{profile['flash_share_of_device']:.1%} of device time")
    for r in profile["top"]:
        log(f"[{tag}]   {r['us']:10.1f} us x{r['launches']:<4d} {r['kernel']}")
    del params
    torch.cuda.empty_cache()
    return out


def phase_serve() -> dict:
    """TinyLlama-1.1B at full width and depth in bf16 through the engine
    (``_serve_bf16``): 22 launches of the tensor-core kernel a prefill."""
    return _serve_bf16(SERVE["arch"], "serve", 6)


def _isolated_generate(model, params, prompt, n_new):
    """Exact-length prefill + greedy decode of one request alone; returns
    the tokens and each step's top-2 logit margin. A length an ``ssd``
    group's scan refuses (past the chunk and not a multiple of it) is
    prefilled to its longest multiple of the chunk and the rest fed to
    ``decode_step`` a token at a time."""
    dev = params["embed"]["table"].device
    cfg, n = model.cfg, len(prompt)
    if (any(g.kind == "ssd" for g in model.groups) and n > cfg.ssm_chunk
            and n % cfg.ssm_chunk):
        n -= n % cfg.ssm_chunk
    toks = torch.tensor([prompt], dtype=torch.int64, device=dev)
    logits, state = model.prefill(params, {"inputs": toks[:, :n]},
                                  cache_len=SERVE["cache_len"])
    state["index"] = torch.tensor([n], dtype=torch.int32, device=dev)
    for i in range(n, len(prompt)):
        logits, state = model.decode_step(params, state, toks[:, i:i + 1])
    out, margins = [], []
    for step in range(n_new):
        if step:
            logits, state = model.decode_step(
                params, state, torch.tensor([[out[-1]]], device=dev))
        top2 = torch.topk(logits[0].float(), 2).values
        margins.append(float(top2[0] - top2[1]))
        out.append(int(torch.argmax(logits[0])))
    return out, margins



def _one_slot_generate(model, params, prompt, n_new):
    """One request alone through a ``max_batch=1`` engine (a moe model's
    oracle: the same bucketed admission, so the same capacities, and a
    decode that drops nothing); returns its tokens and the top-2 logit
    margin of each logits row a token came from."""
    import copy

    from repro_torch.serving import Request, ServingEngine

    margins = []

    def margin(logits):
        top2 = torch.topk(logits[0].float(), 2).values
        margins.append(float(top2[0] - top2[1]))

    def prefill(p, batch, **kw):  # its logits give a token when unpadded
        logits, state = model.prefill(p, batch, **kw)
        if batch["inputs"].shape[1] == len(prompt):
            margin(logits)
        return logits, state

    def decode_step(p, state, toks):
        logits, state = model.decode_step(p, state, toks)
        margin(logits)
        return logits, state
    spy = copy.copy(model)
    spy.prefill, spy.decode_step = prefill, decode_step
    engine = ServingEngine(spy, params, max_batch=1,
                           cache_len=SERVE["cache_len"])
    req = Request(uid=0, prompt=prompt, max_new_tokens=n_new)
    engine.submit(req)
    engine.run()
    check(req.done and len(margins) == n_new,
          f"one-slot engine: {len(req.generated)} tokens, {len(margins)} "
          f"logits rows")
    return req.generated, margins


def _serve_f32(arch: str, tag: str, n_layers=None, *,
               new_tokens: "int | None" = None, **cuts) -> dict:
    """The model in float32 (TF32 off; depth cut to ``n_layers`` and any
    other field to ``cuts`` where given; SERVE's requests, each of
    ``new_tokens`` new tokens, SERVE's where None): the engine's tokens
    equal each request's oracle, token for token (its isolated prefill +
    greedy decode; for a moe model, the request alone through a one-slot
    engine, ``_one_slot_generate``); the 2048-token prefill's logits
    through the tf32x3 kernel against the plain version
    (``_hold_kernel_in_prefill``), its ms and its profile."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = _card()
    torch.cuda.empty_cache()
    cfg, model, params, init_s = _serve_model(torch.float32, arch, n_layers,
                                              **cuts)
    n_attn = _attn_layers(model)
    moe = any(g.kind == "moe" for g in model.groups)
    oracle, oracle_name = ((_one_slot_generate, "a one-slot engine") if moe
                           else (_isolated_generate, "isolated prefill + "
                                 "greedy decode"))
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        reqs = _serve_requests(cfg.vocab, new_tokens)
        new_tokens = reqs[0].max_new_tokens
        run = _run_engine(model, params, reqs)
        run.pop("engine")
        peak = torch.cuda.max_memory_allocated()
        got = {k: run["launches"][k] for k in NO_LM}
        check(got == _flash_want(n_attn * len(reqs), "tf32x3"),
              f"{tag} {arch}: launches {run['launches']} (one launch of the "
              f"tf32x3 kernel per attention layer per prefill)")
        min_margin = math.inf
        for r in reqs:
            want, margins = oracle(model, params, r.prompt, r.max_new_tokens)
            min_margin = min(min_margin, min(margins))
            if r.generated != want:
                step = next(i for i, (a, b) in enumerate(zip(r.generated,
                                                             want)) if a != b)
                raise SmokeFailure(
                    f"{tag} {arch}: request {r.uid} (prompt {len(r.prompt)}) "
                    f"differs from {oracle_name} at step {step}: engine "
                    f"{r.generated[step]} vs {want[step]}, top-2 margin "
                    f"there {margins[step]:.3e}")
        gen = torch.Generator(device=dev).manual_seed(7)
        tokens = torch.randint(0, cfg.vocab, (1, 2048), generator=gen,
                               device=dev)
        logits, routes = _prefill_routed(model, params, tokens)
        held = _hold_kernel_in_prefill(
            model, params, tokens, logits, routes, lambda top: F32_LOGIT_TOL,
            f"[{tag}] {arch} 2048-token prefill")
        err = held["max_abs_err"]
        ms = _bare_ms(lambda: model.prefill(
            params, {"inputs": tokens}, cache_len=SERVE["cache_len"]), 5)
        prefill_ms = sorted(ms)[len(ms) // 2]
        profile = _prefill_profile(model, params, tokens)
    log(f"[{tag}] {arch} at {cfg.n_layers} layers "
        f"{[(g.kind, g.n) for g in model.groups]}, cut "
        f"{_cut_list(cfg) or 'none'}: {len(reqs)} requests x "
        f"{new_tokens} tokens: engine == {oracle_name}, token for "
        f"token (smallest top-2 margin {min_margin:.3e}); "
        f"engine {run['tokens_per_s']:.1f} tokens/s in {run['wall_s']:.3f} "
        f"s; launches { {k: v for k, v in got.items() if v} }; 2048-token "
        f"prefill logits kernel vs plain {err:.3e} (tolerance "
        f"{F32_LOGIT_TOL}); peak memory {peak / 2**30:.3f} GiB; init "
        f"{init_s:.2f} s")
    log(f"[{tag}] {arch} prefill 2048 tokens: {prefill_ms:.3f} ms median of "
        f"{len(ms)} ({min(ms):.3f}..{max(ms):.3f}); profile: flash kernel "
        f"{profile['flash_us'] / 1e3:.3f} ms = "
        f"{profile['flash_share_of_device']:.1%} of device time "
        f"({profile['device_busy_us'] / 1e3:.3f} ms), wall "
        f"{profile['wall_us'] / 1e3:.3f} ms")
    for r in profile["top"]:
        log(f"[{tag}]   {r['us']:10.1f} us x{r['launches']:<4d} "
            f"{r['kernel']}")
    del params
    torch.cuda.empty_cache()
    return {**run, "n_layers": cfg.n_layers, "cuts": _cut_list(cfg),
            "init_s": init_s, "oracle": oracle_name,
            "peak_memory_bytes": peak, "min_top2_margin": min_margin,
            "logits_2048_max_abs_err": err, "logits_2048": held,
            "prefill_2048_ms": ms, "prefill_2048_profile": profile}


def phase_serve_f32() -> dict:
    """The TinyLlama model in float32 (TF32 off): the engine's tokens equal
    each request's isolated prefill + greedy decode (``_serve_f32``)."""
    return _serve_f32(SERVE["arch"], "serve f32")


# ---------------------------------------------------------------------------
# 11b. recurrent: mamba2-780m and recurrentgemma-2b through the engine
# ---------------------------------------------------------------------------

RECURRENT = dict(archs=("mamba2-780m", "recurrentgemma-2b"),
                 # the float32 twins' depth: mamba2 6 of its 48 layers,
                 # recurrentgemma 8 of its 26 (two griffin super-blocks and
                 # a rec group of 2); their engine runs and isolated
                 # generations step token by token, and time is the cut
                 # (mamba2's 12 until phase 14 trained every kind)
                 f32_layers={"mamba2-780m": 6, "recurrentgemma-2b": 8},
                 # the bf16 engine's new tokens a request (SERVE's 64 until
                 # phase 14 trained every kind: mamba2 decodes at ~0.3 s a
                 # step there)
                 new_tokens=16,
                 loss_batch=1, loss_seq=2048, seed=0)


def _recurrent_loss(arch: str, spec: dict = RECURRENT,
                    tag: str = "recurrent loss", card: str = "") -> dict:
    """One LM.loss forward and backward at full width and depth, bf16,
    remat on, batch ``spec["loss_batch"]`` x ``spec["loss_seq"]`` from
    FastLMStream: CE and gradients through the kernels against the plain
    versions' (phase 13's tolerances) with the launches counted where the
    model has attention (recurrentgemma, gemma3); mamba2's finite; timed."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.base import root_key
    from repro_torch.data import FastLMStream
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models.lm import LM
    from repro_torch.tree import leaves

    dev = _card()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(arch), dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, remat=True)
    model = LM(cfg)
    params = model.init(root_key(spec["seed"], device=dev))
    b, t = spec["loss_batch"], spec["loss_seq"]
    batch = next(iter(FastLMStream(cfg.vocab, t, b, seed=spec["seed"],
                                   device=dev).batches(1)))
    n_attn = _attn_layers(model)
    tol = TRAIN_TOL[torch.bfloat16]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    loss, _, grads = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in leaves(grads))
    check(finite, f"{tag} {arch}: loss or a gradient not finite")
    route = kflash.flash_bwd_route(torch.bfloat16, cfg.head_dim)
    splits = _bwd_splits(route, b, t, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim) if n_attn else 1
    want = {op: 0 for op in counts}
    if n_attn:
        want.update({**_flash_want(2 * n_attn, "sm90"),
                     "flash_attention_bwd": n_attn,
                     f"flash_attention_bwd_{route}": n_attn,
                     f"flash_attention_bwd_{route}_sum":
                         n_attn * (splits > 1),
                     **{f"flash_attention_bwd_{k}": n_attn
                        for k in BWD_ROUTE_KERNELS[route]}})
    check(counts == want, f"{tag} {arch}: launches {counts} != {want} "
          f"(remat: the forward twice an attention layer, the backward "
          f"once)")
    del grads
    out = {"arch": arch, "batch": b, "seq": t, "loss": float(loss),
           "launches": counts, "peak_memory_bytes": peak, "splits": splits}
    if n_attn:
        out["step0"] = _step0_grads(model, params, batch)
        ce_err = abs(out["step0"]["loss"] - out["step0"]["loss_plain"]) / abs(
            out["step0"]["loss_plain"])
        out["ce_rel_err"] = ce_err
        check(ce_err <= tol["ce"], f"{tag} {arch}: CE through the "
              f"kernels differs from the plain versions' by {ce_err:.3e}")
        check(out["step0"]["grad_rel_norm_err"] <= tol["grad"],
              f"{tag} {arch}: gradients differ from the plain "
              f"versions' by {out['step0']['grad_rel_norm_err']:.3e} "
              f"(relative norm, worst leaf) > {tol['grad']}")
    torch.cuda.empty_cache()
    ms = _bare_ms(lambda: loss_and_grads(model, params, batch), 3)
    out["ms"] = ms
    plain = (f"; vs the plain versions: CE rel err {out['ce_rel_err']:.2e} "
             f"(tol {tol['ce']}), gradients' worst relative norm error "
             f"{out['step0']['grad_rel_norm_err']:.2e} over "
             f"{out['step0']['leaves']} leaves (tol {tol['grad']})"
             if n_attn else "")
    log(f"[{tag}] {arch} bf16 {cfg.n_layers} layers, remat, "
        f"{b} x {t} tokens: loss {float(loss):.5f}, gradients finite; "
        f"{sorted(ms)[1]:.2f} ms a forward and backward (median of 3, "
        f"{min(ms):.2f}..{max(ms):.2f}), {b * t / sorted(ms)[1] * 1e3:,.0f} "
        f"tokens/s; peak {peak / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in counts.items() if v} }{plain}"
        + (f" ({card})" if card else ""))
    del params
    torch.cuda.empty_cache()
    return out


def phase_recurrent(card: str) -> dict:
    """11b: mamba2-780m and recurrentgemma-2b served at full width and
    depth in bf16, their f32 twins' engine against isolated generation,
    and one loss step each."""
    t0 = time.perf_counter()
    record = {"card": card}
    for arch in RECURRENT["archs"]:
        record[arch] = {
            "serve": _serve_bf16(arch, "recurrent", 17,
                                 new_tokens=RECURRENT["new_tokens"]),
            "serve_f32": _serve_f32(arch, "recurrent f32",
                                    RECURRENT["f32_layers"][arch]),
            "loss": _recurrent_loss(arch)}
    record["seconds"] = time.perf_counter() - t0
    log(f"[recurrent] phase 11b on {card} took {record['seconds']:.1f} s")
    return record


# ---------------------------------------------------------------------------
# 11c. moe: arctic-480b and kimi-k2-1t-a32b through the engine
# ---------------------------------------------------------------------------

MOE = dict(archs=("arctic-480b", "kimi-k2-1t-a32b"),
           # the bf16 serving depth, every width kept: arctic 2 of its 35
           # layers (55.4 GB of weights; 3 would be 82.6 GB), kimi its
           # dense first layer and one moe layer of 61 (39.8 GB)
           layers={"arctic-480b": 2, "kimi-k2-1t-a32b": 2},
           # the float32 twins (TF32 off): arctic 1 layer (56 GB), kimi 2
           # layers with 128 of its 384 experts (top-8, moe_d_ff, heads
           # and head dim kept)
           f32={"arctic-480b": dict(n_layers=1),
                "kimi-k2-1t-a32b": dict(n_layers=2, n_experts=128)},
           # one LM.loss forward and backward: arctic at 1 layer, bf16,
           # remat (kimi's 39.8 GB of bf16 weights and as many of
           # gradients do not fit the card)
           loss_arch="arctic-480b", loss_layers=1, loss_batch=1,
           loss_seq=2048, seed=0)


def _grads_rel_err(host_grads: list, grads: list, chunk: int = 1 << 27) -> list:
    """Each leaf's relative norm error of ``host_grads`` (leaves kept on
    the host) against ``grads`` (on the card), ``chunk`` values at a time
    (a float32 copy of a whole expert stack's gradient does not fit)."""
    errs = []
    for a, b in zip(host_grads, grads):
        a, b = a.reshape(-1), b.reshape(-1)
        diff2 = ref2 = 0.0
        for i in range(0, b.numel(), chunk):
            bc = b[i:i + chunk].float()
            ac = a[i:i + chunk].to(b.device).float()
            diff2 += float(torch.linalg.vector_norm(ac - bc,
                                                    dtype=torch.float64) ** 2)
            ref2 += float(torch.linalg.vector_norm(bc,
                                                   dtype=torch.float64) ** 2)
        errs.append((diff2 / max(ref2, 1e-60)) ** 0.5)
    return errs


def _moe_loss() -> dict:
    """One LM.loss forward and backward of arctic at full width, 1 layer,
    bf16, remat, 1 x 2048 tokens from FastLMStream: the launches (the
    forward twice, the sm90 backward once in 7 runs of heads and a sum
    pass), CE, aux and every gradient against the plain versions'
    (phase 13's tolerances where no route flips; the gradients through
    the kernels wait on the host, since two bf16 gradient trees and the
    weights do not fit the card), peak memory and ms."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.base import root_key
    from repro_torch.data import FastLMStream
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models import moe
    from repro_torch.models.lm import LM
    from repro_torch.tree import leaves

    dev = _card()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(MOE["loss_arch"]),
                              dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                              remat=True, n_layers=MOE["loss_layers"])
    model = LM(cfg)
    params = model.init(root_key(MOE["seed"], device=dev))
    b, t = MOE["loss_batch"], MOE["loss_seq"]
    batch = next(iter(FastLMStream(cfg.vocab, t, b, seed=MOE["seed"],
                                   device=dev).batches(1)))
    tol = TRAIN_TOL[torch.bfloat16]
    label = f"[moe loss] {cfg.arch_id}"
    # the routes of the loss's forward through the kernels and the plain
    # versions (no grad: the same forward, no remat)
    with torch.no_grad():
        with moe.record_routes() as routes:
            model.loss(params, batch)
        with ops.use_impl("ref"), moe.record_routes() as want_routes:
            model.loss(params, batch)
    flips = _route_flips(routes, want_routes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    loss, metrics, grads = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    flat = leaves(grads)
    check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                             for g in flat),
          f"{label}: loss or a gradient not finite")
    L = cfg.n_layers
    route = kflash.flash_bwd_route(torch.bfloat16, cfg.head_dim)
    splits = _bwd_splits(route, b, t, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim)
    want = {op: 0 for op in counts}
    want.update({**_flash_want(2 * L, "sm90"), "flash_attention_bwd": L,
                 f"flash_attention_bwd_{route}": L,
                 f"flash_attention_bwd_{route}_sum": L * (splits > 1),
                 **{f"flash_attention_bwd_{k}": L
                    for k in BWD_ROUTE_KERNELS[route]}})
    check(counts == want, f"{label}: launches {counts} != {want} (remat: the "
          f"forward twice a layer, the backward once)")
    host = [g.to("cpu") for g in flat]
    del grads, flat
    torch.cuda.empty_cache()
    with ops.use_impl("ref"):
        loss_r, metrics_r, grads_r = loss_and_grads(model, params, batch)
    errs = _grads_rel_err(host, leaves(grads_r))
    del host, grads_r
    torch.cuda.empty_cache()
    rel = {name: abs(float(metrics[name]) - float(metrics_r[name]))
           / abs(float(metrics_r[name])) for name in ("ce", "aux")}
    out = {"arch": cfg.arch_id, "n_layers": L, "cuts": _cut_list(cfg),
           "batch": b, "seq": t, "loss": float(loss),
           "ce": float(metrics["ce"]), "aux": float(metrics["aux"]),
           "ce_plain": float(metrics_r["ce"]),
           "aux_plain": float(metrics_r["aux"]), "rel_err": rel,
           "grad_rel_norm_err": max(errs), "leaves": len(errs),
           "route_flips": flips, "launches": counts, "splits": splits,
           "peak_memory_bytes": peak, "tolerance": tol}
    flipped = flips["choices"] or flips["keeps"]
    check(abs(float(loss) - (float(metrics["ce"])
                             + 0.01 * float(metrics["aux"]))) <= 1e-6 * abs(
        float(loss)) and float(metrics["aux"]) > 0,
          f"{label}: loss {float(loss)} != ce + 0.01 aux, or aux <= 0")
    if not flipped:
        check(rel["ce"] <= tol["ce"] and rel["aux"] <= tol["ce"],
              f"{label}: CE or aux through the kernels differ from the plain "
              f"versions' by {rel} > {tol['ce']}")
        check(max(errs) <= tol["grad"], f"{label}: gradients differ from "
              f"the plain versions' by {max(errs):.3e} (relative norm, "
              f"worst leaf) > {tol['grad']}")
    ms = _bare_ms(lambda: loss_and_grads(model, params, batch), 3)
    out["ms"] = ms
    log(f"{label} bf16 {L} layer, full width, remat, {b} x {t} tokens: "
        f"loss {float(loss):.5f} = ce {out['ce']:.5f} + 0.01 aux "
        f"{out['aux']:.5f}; {flips['choices']} of {flips['assignments']} "
        f"expert choices and {flips['keeps']} keeps differ from the plain "
        f"versions' routes; vs the plain versions: CE rel err "
        f"{rel['ce']:.2e}, aux {rel['aux']:.2e} (tol {tol['ce']}), "
        f"gradients' worst relative norm error {max(errs):.2e} over "
        f"{len(errs)} leaves (tol {tol['grad']})"
        + (" - not held: routes flipped; the backward is held at this "
           "layer's attention shape in phase 13" if flipped else ""))
    log(f"{label}: {sorted(ms)[1]:.2f} ms a forward and backward (median of "
        f"3, {min(ms):.2f}..{max(ms):.2f}), {b * t / sorted(ms)[1] * 1e3:,.0f}"
        f" tokens/s; peak {peak / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in counts.items() if v} } ({splits} runs of "
        f"heads)")
    del params
    torch.cuda.empty_cache()
    return out


def phase_moe(card: str) -> dict:
    """11c: arctic-480b and kimi-k2-1t-a32b served at full width, depth
    cut, in bf16; their f32 twins' engines against one-slot engines; and
    arctic's loss step."""
    t0 = time.perf_counter()
    record = {"card": card}
    for arch in MOE["archs"]:
        record[arch] = {
            "serve": _serve_bf16(arch, "moe", 27, MOE["layers"][arch]),
            "serve_f32": _serve_f32(arch, "moe f32", **MOE["f32"][arch])}
    record["loss"] = _moe_loss()
    record["seconds"] = time.perf_counter() - t0
    log(f"[moe] phase 11c on {card} took {record['seconds']:.1f} s")
    return record


# ---------------------------------------------------------------------------
# 11d. cross: whisper-tiny and llama-3.2-vision-90b, prefill + greedy decode
# ---------------------------------------------------------------------------

CROSS = dict(
    archs=("whisper-tiny", "llama-3.2-vision-90b"),
    # launch/serve.py's loop at batch 4: whisper whole (4 encoder + 4
    # decoder layers), 1500 frames and 128 prompt tokens a row, a cache of
    # 192 (its published text context is 448 tokens, arXiv:2212.04356);
    # the vision model at 30 of its 100 layers (6 of its 20 super-blocks,
    # 55.56 GB of bf16 weights; every width kept), 512 prompt tokens and
    # 1601 x 1280 patch embeddings a row, a cache of 576
    serve={"whisper-tiny": dict(n_layers=None, batch=4, prompt=128, new=64,
                                cache_len=192),
           "llama-3.2-vision-90b": dict(n_layers=30, batch=4, prompt=512,
                                        new=64, cache_len=576)},
    long_prompt=2048,  # the batch-1 prefill held against the plain versions
    # the float32 twins (TF32 off): whisper whole, the vision model at one
    # super-block (5 layers, 25.6 GB)
    f32_layers={"whisper-tiny": None, "llama-3.2-vision-90b": 5},
    # one LM.loss forward and backward in bf16 with remat: whisper whole on
    # 8 x 448 decoder tokens over 8 x 1500 frames; the vision model at 5
    # layers (12.8 GB of weights, as many of gradients) on 1 x 2048 tokens
    loss={"whisper-tiny": dict(n_layers=None, batch=8, seq=448),
          "llama-3.2-vision-90b": dict(n_layers=5, batch=1, seq=2048)},
    # the vlm's gates start at zero, which keeps the vision memory from
    # every output: each run draws them U(0.5, 1.0) from root_key(0, 11)
    gates=(0.5, 1.0), seed=0)


@contextlib.contextmanager
def _by_causal():
    """The flash kernels' calls while the block runs, by their causal
    flag: {"fwd": {"causal": n, "non-causal": n}, "bwd": {...}}; each call
    of the wrapped entry points is one launch (its counters say so)."""
    from repro_torch.kernels import flash_attention as kflash

    calls = {way: {"causal": 0, "non-causal": 0} for way in ("fwd", "bwd")}
    fwd, bwd = kflash._forward, kflash.flash_attention_bwd_cuda

    def spy_fwd(*args, causal, **kw):
        calls["fwd"]["causal" if causal else "non-causal"] += 1
        return fwd(*args, causal=causal, **kw)

    def spy_bwd(*args, causal=True, **kw):
        calls["bwd"]["causal" if causal else "non-causal"] += 1
        return bwd(*args, causal=causal, **kw)
    kflash._forward, kflash.flash_attention_bwd_cuda = spy_fwd, spy_bwd
    try:
        yield calls
    finally:
        kflash._forward, kflash.flash_attention_bwd_cuda = fwd, bwd


@contextlib.contextmanager
def _cross_range(name: str = "attn_cross"):
    """``attention.attn_cross`` inside a profiler range of ``name``: the
    float32 cross-attention products (and its two projections) named in a
    profile."""
    from repro_torch.models import attention as attn

    plain = attn.attn_cross

    def ranged(*args, **kw):
        with torch.profiler.record_function(name):
            return plain(*args, **kw)
    attn.attn_cross = ranged
    try:
        yield
    finally:
        attn.attn_cross = plain


def _cross_model(arch: str, dtype, n_layers=None):
    """(cfg, model, params from seed 0 on the card, init s, the vlm's gate
    values or None): ``_serve_model``'s, with the vlm's gates drawn from
    ``CROSS["gates"]``."""
    from repro_torch.core.base import root_key

    cfg, model, params, init_s = _serve_model(dtype, arch, n_layers)
    gates = None
    if cfg.family == "vlm":
        gen = root_key(CROSS["seed"], 11, device=_card())
        cross = params["group0"]["cross"]
        for name in ("gate", "gate_mlp"):
            cross[name].uniform_(*CROSS["gates"], generator=gen)
        gates = {name: cross[name].float().tolist()
                 for name in ("gate", "gate_mlp")}
    return cfg, model, params, init_s, gates


def _cross_batch(cfg, b: int, t: int, gen) -> dict:
    """launch/serve.py's synthetic batch: (B, T) token ids, then the
    family's standard normal float32 payload."""
    dev = _card()
    batch = {"inputs": torch.randint(0, cfg.vocab, (b, t), generator=gen,
                                     device=dev)}
    if cfg.family == "vlm":
        batch["vision"] = torch.randn((b, cfg.vision_tokens, cfg.vision_dim),
                                      generator=gen, device=dev)
    else:
        batch["audio_frames"] = torch.randn(
            (b, cfg.audio_frames, cfg.d_model), generator=gen, device=dev)
    return batch


def _cross_attn_layers(model) -> "tuple[int, int]":
    """(causal, non-causal) flash launches of a prefill: the self layers of
    the vlm super-blocks or whisper's decoder units, and whisper's encoder
    layers."""
    cfg = model.cfg
    causal = sum(g.n * (cfg.cross_attn_every if g.kind == "vlm" else 1)
                 for g in model.groups)
    return causal, cfg.encoder_layers


def _generate(model, params, batch, new: int, cache_len: int) -> dict:
    """launch/serve.py's loop: a batched prefill, then greedy decode to
    ``new`` tokens a row: the tokens (B, new), each row's smallest top-2
    logit margin, prefill and decode seconds, and the launches of each
    part (with the prefill's flash calls by causal flag)."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with _by_causal() as calls:
        t0 = time.perf_counter()
        logits, state = model.prefill(params, batch, cache_len=cache_len)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    prefill_launches = ops.launch_counts()
    ops.reset_launch_counts()
    toks = torch.argmax(logits, dim=-1)[:, None]
    out, margins = [toks], []
    t0 = time.perf_counter()
    for step in range(new):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        if step == new - 1:
            break
        logits, state = model.decode_step(params, state, toks)
        toks = torch.argmax(logits, dim=-1)[:, None]
        out.append(toks)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1),
            "min_margin": torch.stack(margins).min(dim=0).values.tolist(),
            "prefill_s": prefill_s, "decode_s": decode_s,
            "prefill_launches": prefill_launches, "prefill_calls": calls,
            "decode_launches": ops.launch_counts()}


def _check_prefill_launches(run: dict, model, route: str, label: str) -> None:
    causal, non_causal = _cross_attn_layers(model)
    got = {k: run["prefill_launches"][k] for k in NO_LM}
    check(got == _flash_want(causal + non_causal, route),
          f"{label}: prefill launches {got} (want {causal} causal and "
          f"{non_causal} non-causal {route} launches)")
    check(run["prefill_calls"]["fwd"] == {"causal": causal,
                                          "non-causal": non_causal},
          f"{label}: prefill flash calls by mask {run['prefill_calls']}")
    check(all(n == 0 for n in run["decode_launches"].values()),
          f"{label}: decode launched {run['decode_launches']}")


def _ulps_tol(top: float) -> float:
    """``BF16_ULPS`` bf16 ulps of the largest |value|."""
    return BF16_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)


def _held(got: torch.Tensor, want: torch.Tensor, label: str) -> dict:
    """``got`` through the kernels against ``want`` through the plain
    versions within ``BF16_ULPS`` bf16 ulps of max |want|."""
    got, want = got.float(), want.float()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{label}: not finite or misshapen {tuple(got.shape)}")
    top = float(want.abs().max())
    err, tol = _max_err(got, want), _ulps_tol(top)
    log(f"{label}: kernels vs plain max abs err {err:.4e} (tolerance "
        f"{tol:.4e}, {BF16_ULPS} bf16 ulps of max |value| {top:.3f})")
    check(err <= tol, f"{label}: through the kernels differs from the plain "
          f"versions by {err:.4e} > {tol:.4e}")
    return {"max_abs_err": err, "tolerance": tol, "max_abs": top}


def _serve_cross(arch: str, card: str, seed: int) -> dict:
    """One cross-attention model in bf16 at full width (``CROSS["serve"]``'s
    depth): launch/serve.py's batched prefill and greedy decode, checked
    and timed; the prefill's logits (whisper: and its encoder's output)
    through the kernels against the plain versions', the vision model's
    on a batch-1 2048-token prefill too; a profiled prefill with the
    cross attention as a named range, and one cross layer's products
    alone."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    from repro_torch.models import lm as lm_mod

    dev = _card()
    torch.cuda.empty_cache()
    spec = CROSS["serve"][arch]
    cfg, model, params, init_s, gates = _cross_model(arch, torch.bfloat16,
                                                     spec["n_layers"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, t, new, cache_len = (spec[k] for k in ("batch", "prompt", "new",
                                              "cache_len"))
    tag = f"[cross] {arch}"
    out = {"arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "groups": [(g.kind, g.n) for g in model.groups],
           "cuts": _cut_list(cfg), "dtype": "bfloat16", "init_s": init_s,
           "gates": gates, "batch": b, "prompt": t, "new_tokens": new,
           "cache_len": cache_len}
    with torch.no_grad():
        warm = _cross_batch(cfg, 1, 64, gen)
        model.prefill(params, warm, cache_len=128)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        batch = _cross_batch(cfg, b, t, gen)
        run = _generate(model, params, batch, new, cache_len)
        peak = torch.cuda.max_memory_allocated()
        _check_prefill_launches(run, model, "sm90", tag)
        toks = run["tokens"]
        check(toks.shape == (b, new) and bool(((toks >= 0)
                                               & (toks < cfg.vocab)).all()),
              f"{tag}: generated tokens misshapen or out of the vocab")
        again = _generate(model, params, batch, new, cache_len)
        check(torch.equal(again["tokens"], toks),
              f"{tag}: a second generation of the same batch differs")
        prefill_ms = _bare_ms(lambda: model.prefill(params, batch,
                                                    cache_len=cache_len), 3)
        memory_key = "vision" if cfg.family == "vlm" else "audio_frames"
        out.update({
            "launches_prefill": {k: v for k, v in
                                 run["prefill_launches"].items() if v},
            "flash_calls_prefill": run["prefill_calls"]["fwd"],
            "peak_memory_bytes": peak, "prefill_ms": prefill_ms,
            "generate_prefill_ms": again["prefill_s"] * 1e3,
            "decode_ms_per_step": again["decode_s"] * 1e3 / (new - 1),
            "prefill_tokens_per_s": b * t / again["prefill_s"],
            "decode_tokens_per_s": b * (new - 1) / again["decode_s"],
            "tokens_per_s": b * new / (again["prefill_s"]
                                       + again["decode_s"]),
            "min_top2_margin": min(again["min_margin"])})
        if cfg.family == "audio":
            frames = batch["audio_frames"].to(cfg.dtype)
            ms = _bare_ms(lambda: model._encode_audio(params, frames), 5)
            out["encoder_ms"] = ms
            got = model._encode_audio(params, frames)
            with ops.use_impl("ref"):
                want = model._encode_audio(params, frames)
            out["encoder"] = _held(got, want, f"{tag} encoder output "
                                   f"{tuple(got.shape)}")
            logits_batch = batch
        else:
            logits_batch = _cross_batch(cfg, 1, CROSS["long_prompt"], gen)
        ops.reset_launch_counts()
        with _by_causal() as calls:
            got = model.prefill(params, logits_batch,
                                cache_len=logits_batch["inputs"].shape[1])[0]
        causal, non_causal = _cross_attn_layers(model)
        check(ops.launch_counts()["flash_attention_sm90"] == causal
              + non_causal and calls["fwd"]["non-causal"] == non_causal,
              f"{tag}: the held prefill launched {ops.launch_counts()}")
        with ops.use_impl("ref"):
            want = model.prefill(params, logits_batch,
                                 cache_len=logits_batch["inputs"].shape[1])[0]
        lb, lt = logits_batch["inputs"].shape
        out["logits"] = _held(got, want, f"{tag} prefill logits of {lb} x "
                              f"{lt} tokens")
        out["logits"]["argmax_equal"] = bool(
            (got.argmax(-1) == want.argmax(-1)).all())
        del got, want
        with _cross_range():
            profile = _profile_call(lambda: model.prefill(
                params, logits_batch, cache_len=lt), ranges=("attn_cross",))
        out["prefill_profile"] = profile
        # one cross layer's attention alone at the held prefill's shape
        p = lm_mod._layer(params["group0"], 0)
        p_attn = p["cross"]["attn"] if cfg.family == "vlm" else p["cross_attn"]
        memory = model._inject_memory(params, logits_batch)
        mkv = attn.cross_kv(p_attn, memory, cfg)
        x = torch.randn((lb, lt, cfg.d_model), generator=gen,
                        device=dev).to(cfg.dtype)
        layer_ms = _time_ms(lambda: attn.attn_cross(p_attn, x, mkv, cfg), 5)
        by_kernel = _device_kernels_ms(
            lambda: attn.attn_cross(p_attn, x, mkv, cfg), 5)
        s_mem = memory.shape[1]
        # the two float32 products: 2 flops a multiply-add, Q K^T and P V
        flops = 2 * 2 * lb * cfg.n_heads * lt * s_mem * cfg.head_dim
        bound, bound_by = _bound_ms(0, 0, flops, torch.float32)
        out["cross_layer"] = {"shape": [lb, lt, s_mem], "ms": layer_ms,
                              "device_ms_by_kernel": by_kernel,
                              "products_gflop": flops / 1e9,
                              "products_fp32_bound_ms": bound}
        del memory, mkv, x
    med = sorted(prefill_ms)[1]
    log(f"{tag} bf16, {cfg.n_layers} layers {out['groups']}, d "
        f"{cfg.d_model}, cut {out['cuts'] or 'none'}; gates {gates}: batch "
        f"{b} x {t} tokens + {memory_key} {tuple(batch[memory_key].shape)}, "
        f"{new} new tokens, cache {cache_len}: prefill {med:.2f} ms (median "
        f"of 3, {min(prefill_ms):.2f}..{max(prefill_ms):.2f}; "
        f"{out['prefill_tokens_per_s']:,.0f} tokens/s), decode "
        f"{out['decode_ms_per_step']:.3f} ms a step "
        f"({out['decode_tokens_per_s']:,.1f} tokens/s), "
        f"{out['tokens_per_s']:,.1f} tokens/s end to end; peak memory "
        f"{peak / 2**30:.2f} GiB; prefill launches "
        f"{out['launches_prefill']} ({run['prefill_calls']['fwd']}), decode "
        f"none; smallest top-2 margin {out['min_top2_margin']:.3e}; init "
        f"{init_s:.2f} s ({card})")
    if "encoder_ms" in out:
        ms = out["encoder_ms"]
        log(f"{tag} encoder alone ({b} x {cfg.audio_frames} frames, "
            f"{cfg.encoder_layers} non-causal layers): "
            f"{sorted(ms)[2]:.3f} ms median of 5 ({min(ms):.3f}.."
            f"{max(ms):.3f}) ({card})")
    log(f"{tag} profile of a {lb} x {lt} prefill: device busy "
        f"{profile['device_busy_us'] / 1e3:.3f} ms = "
        f"{profile['busy_share']:.1%} of wall {profile['wall_us'] / 1e3:.3f} "
        f"ms; flash {profile['flash_us'] / 1e3:.3f} ms; cross attention "
        f"(the attn_cross range's device span: its projections and float32 "
        f"products) {profile['ranges_us']['attn_cross'] / 1e3:.3f} ms "
        f"({card})")
    for r in profile["top"]:
        log(f"{tag}   {r['us']:10.1f} us x{r['launches']:<4d} {r['kernel']}")
    cl = out["cross_layer"]
    log(f"{tag} one cross layer at ({lb}, {lt}) over {cl['shape'][2]} memory "
        f"tokens: {cl['ms']:.3f} ms; its float32 products "
        f"{cl['products_gflop']:.1f} GFLOP (FP32 SIMT bound "
        f"{cl['products_fp32_bound_ms']:.3f} ms); kernels: "
        + "; ".join(f"{k[:70]} {v:.3f}"
                    for k, v in sorted(by_kernel.items(),
                                       key=lambda kv: -kv[1])[:6])
        + f" ({card})")
    del params
    torch.cuda.empty_cache()
    return out


def _serve_cross_f32(arch: str, card: str, seed: int) -> dict:
    """The float32 twin (TF32 off, ``CROSS["f32_layers"]``): the batch's
    generation on the tf32x3 kernel equals each row generated alone at
    batch 1, token for token."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = _card()
    torch.cuda.empty_cache()
    spec = CROSS["serve"][arch]
    cfg, model, params, init_s, gates = _cross_model(
        arch, torch.float32, CROSS["f32_layers"][arch])
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, t, new, cache_len = (spec[k] for k in ("batch", "prompt", "new",
                                              "cache_len"))
    tag = f"[cross f32] {arch}"
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        batch = _cross_batch(cfg, b, t, gen)
        run = _generate(model, params, batch, new, cache_len)
        peak = torch.cuda.max_memory_allocated()
        _check_prefill_launches(run, model, "tf32x3", tag)
        margin = min(run["min_margin"])
        for i in range(b):
            alone = _generate(model, params,
                              {k: v[i:i + 1] for k, v in batch.items()}, new,
                              cache_len)
            margin = min(margin, alone["min_margin"][0])
            row, want = run["tokens"][i].tolist(), alone["tokens"][0].tolist()
            if row != want:
                step = next(j for j, (a, c) in enumerate(zip(row, want))
                            if a != c)
                raise SmokeFailure(
                    f"{tag}: row {i} of the batch differs from the row "
                    f"alone at step {step}: {row[step]} vs {want[step]}")
    out = {"arch": arch, "n_layers": cfg.n_layers, "cuts": _cut_list(cfg),
           "gates": gates, "init_s": init_s, "batch": b, "prompt": t,
           "new_tokens": new, "peak_memory_bytes": peak,
           "min_top2_margin": margin,
           "prefill_ms": run["prefill_s"] * 1e3,
           "decode_ms_per_step": run["decode_s"] * 1e3 / (new - 1),
           "launches_prefill": {k: v for k, v in
                                run["prefill_launches"].items() if v},
           "flash_calls_prefill": run["prefill_calls"]["fwd"]}
    log(f"{tag} at {cfg.n_layers} layers {[(g.kind, g.n) for g in model.groups]}"
        f", cut {out['cuts'] or 'none'}; gates {gates}: {b} rows x {new} "
        f"tokens: the batch's generation == each row alone at batch 1, token "
        f"for token (smallest top-2 margin {margin:.3e}); prefill "
        f"{out['prefill_ms']:.2f} ms, decode {out['decode_ms_per_step']:.3f} "
        f"ms a step; launches {out['launches_prefill']} "
        f"({run['prefill_calls']['fwd']}); peak memory {peak / 2**30:.2f} GiB "
        f"({card})")
    del params
    torch.cuda.empty_cache()
    return out


def _tree_paths(tree, prefix="") -> list:
    """(path, leaf) pairs in ``repro_torch.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in _tree_paths(tree[key], f"{prefix}/{key}")]
    return [(prefix, tree)]


def _cross_loss(arch: str, card: str, seed: int) -> dict:
    """One LM.loss forward and backward in bf16 with remat
    (``CROSS["loss"]``), FastLMStream tokens and the family's payload:
    launches by route and causal flag (the encoder's once, the rest's
    forward twice), CE and every gradient (the gates' among them) through
    the kernels against the plain versions' within phase 13's tolerances,
    peak memory, ms."""
    from repro_torch.data import FastLMStream
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops
    from repro_torch.launch.train import loss_and_grads

    dev = _card()
    torch.cuda.empty_cache()
    spec = CROSS["loss"][arch]
    cfg, model, params, init_s, gates = _cross_model(arch, torch.bfloat16,
                                                     spec["n_layers"])
    check(cfg.remat, f"{arch}: the loss step runs with remat")
    b, t = spec["batch"], spec["seq"]
    batch = next(iter(FastLMStream(cfg.vocab, t, b, seed=CROSS["seed"],
                                   device=dev).batches(1)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch.update({k: v for k, v in _cross_batch(cfg, b, 1, gen).items()
                  if k != "inputs"})
    tag = f"[cross loss] {arch}"
    tol = TRAIN_TOL[torch.bfloat16]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with _by_causal() as calls:
        loss, metrics, grads = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    causal, non_causal = _cross_attn_layers(model)
    route = kflash.flash_bwd_route(torch.bfloat16, cfg.head_dim)
    split_dec = _bwd_splits(route, b, t, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim)
    split_enc = _bwd_splits(route, b, cfg.audio_frames, cfg.n_heads,
                            cfg.n_kv_heads, cfg.head_dim) if non_causal else 1
    n_bwd = causal + non_causal
    want = {op: 0 for op in counts}
    want.update({**_flash_want(2 * causal + non_causal, "sm90"),
                 "flash_attention_bwd": n_bwd,
                 f"flash_attention_bwd_{route}": n_bwd,
                 f"flash_attention_bwd_{route}_sum":
                     causal * (split_dec > 1) + non_causal * (split_enc > 1),
                 **{f"flash_attention_bwd_{k}": n_bwd
                    for k in BWD_ROUTE_KERNELS[route]}})
    check(counts == want, f"{tag}: launches {counts} != {want} (remat: the "
          f"decoder's or super-blocks' forward twice, the encoder's once, "
          f"the backward once a layer)")
    want_calls = {"fwd": {"causal": 2 * causal, "non-causal": non_causal},
                  "bwd": {"causal": causal, "non-causal": non_causal}}
    check(calls == want_calls, f"{tag}: flash calls by mask {calls} != "
          f"{want_calls}")
    host = [(path, g.to("cpu")) for path, g in _tree_paths(grads)]
    check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                             for _, g in host),
          f"{tag}: loss or a gradient not finite")
    del grads
    torch.cuda.empty_cache()
    with ops.use_impl("ref"):
        loss_r, metrics_r, grads_r = loss_and_grads(model, params, batch)
    errs = dict(zip((p for p, _ in host),
                    _grads_rel_err([g for _, g in host],
                                   [g for _, g in _tree_paths(grads_r)])))
    gate_grads = {}
    if cfg.family == "vlm":
        for name in ("gate", "gate_mlp"):
            path = f"/group0/cross/{name}"
            got = dict(host)[path].float()
            plain = grads_r["group0"]["cross"][name].float().cpu()
            check(bool((got != 0).all()), f"{tag}: a zero {name} gradient")
            gate_grads[name] = {"kernels": got.tolist(),
                                "plain": plain.tolist(),
                                "rel_norm_err": errs[path]}
    del host, grads_r
    torch.cuda.empty_cache()
    ce_err = abs(float(metrics["ce"]) - float(metrics_r["ce"])) / abs(
        float(metrics_r["ce"]))
    worst = max(errs, key=errs.get)
    check(ce_err <= tol["ce"], f"{tag}: CE through the kernels differs from "
          f"the plain versions' by {ce_err:.3e} > {tol['ce']}")
    check(errs[worst] <= tol["grad"], f"{tag}: gradient {worst} differs from "
          f"the plain versions' by {errs[worst]:.3e} (relative norm) > "
          f"{tol['grad']}")
    ms = _bare_ms(lambda: loss_and_grads(model, params, batch), 3)
    out = {"arch": arch, "n_layers": cfg.n_layers, "cuts": _cut_list(cfg),
           "gates": gates, "batch": b, "seq": t, "loss": float(loss),
           "ce": float(metrics["ce"]), "ce_plain": float(metrics_r["ce"]),
           "ce_rel_err": ce_err, "grad_rel_norm_err": errs[worst],
           "worst_leaf": worst, "leaves": len(errs),
           "gate_grads": gate_grads, "launches": counts,
           "flash_calls": calls, "splits": [split_dec, split_enc],
           "peak_memory_bytes": peak, "ms": ms, "tolerance": tol}
    memory = ("vision", tuple(batch["vision"].shape)) if "vision" in batch \
        else ("audio_frames", tuple(batch["audio_frames"].shape))
    log(f"{tag} bf16 {cfg.n_layers} layers, cut {out['cuts'] or 'none'}, "
        f"remat, {b} x {t} tokens + {memory[0]} {memory[1]}; gates {gates}: "
        f"CE {out['ce']:.5f} vs plain {out['ce_plain']:.5f} (rel err "
        f"{ce_err:.2e}, tol {tol['ce']}); gradients' worst relative norm "
        f"error {errs[worst]:.2e} at {worst} over {len(errs)} leaves (tol "
        f"{tol['grad']})" + (f"; gate gradients {gate_grads}" if gate_grads
                             else "") + f" ({card})")
    log(f"{tag}: {sorted(ms)[1]:.2f} ms a forward and backward (median of 3, "
        f"{min(ms):.2f}..{max(ms):.2f}), {b * t / sorted(ms)[1] * 1e3:,.0f} "
        f"tokens/s; peak {peak / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in counts.items() if v} }, by mask {calls} "
        f"({card})")
    del params
    torch.cuda.empty_cache()
    return out


def phase_cross(card: str) -> dict:
    """11d: whisper-tiny whole and llama-3.2-vision-90b at 30 layers, every
    width, in bf16 by batched prefill and greedy decode; their f32 twins'
    batches against rows alone; one loss step each."""
    t0 = time.perf_counter()
    record = {"card": card}
    for i, arch in enumerate(CROSS["archs"]):
        record[arch] = {"serve": _serve_cross(arch, card, 41 + i),
                        "serve_f32": _serve_cross_f32(arch, card, 43 + i),
                        "loss": _cross_loss(arch, card, 45 + i)}
    record["seconds"] = time.perf_counter() - t0
    log(f"[cross] phase 11d on {card} took {record['seconds']:.1f} s")
    return record


# ---------------------------------------------------------------------------
# 11e. rightsized: gemma3-1b and gemma3-4b whole at their published contexts
# ---------------------------------------------------------------------------

RIGHTSIZED = dict(
    archs=("gemma3-1b@rightsized", "gemma3-4b@rightsized"),
    # the published contexts (Gemma 3 technical report, arXiv:2503.19786):
    # the engine's cache_len, so each global layer keeps this many slots
    context={"gemma3-1b@rightsized": 32_768, "gemma3-4b@rightsized": 131_072},
    long_prompt=32_768,  # one request beside serve's 8
    # the engine's new tokens a request (SERVE's 64 until phase 14 trained
    # every kind)
    new_tokens=16,
    prefill=(128, 512, 2048, 8192, 32_768),
    # right-sized against uniform on the same weights: a prompt past the
    # 512-token window and decode steps, so the rings wrap in both
    twin=dict(arch="gemma3-1b@rightsized", prompt=1000, cache_len=4096,
              steps=64),
    # the float32 twin's new tokens a request: its isolated generations
    # step one token at a time (~90 ms each), and time is the cut
    f32_new_tokens=16,
    loss_batch=1, loss_seq=4096, seed=0)
# right-sized against uniform decode logits in bf16, the largest |difference|
# over max |logit| at each step: the rings hold the same keys as the uniform
# caches in another slot order, so each attention sums in another order and
# its bf16 output may round the other way
RS_DECODE_TOL = 2e-2


def _kv_leaves(tree) -> list:
    """The ``k`` and ``v`` leaves of a decode state's groups (nested
    dicts), the caches ``attn_decode`` upcasts."""
    out = []
    for name, sub in tree.items():
        if isinstance(sub, dict):
            out += _kv_leaves(sub)
        elif name in ("k", "v"):
            out.append(sub)
    return out


def _state_bytes(state: dict) -> int:
    from repro_torch.tree import leaves

    return sum(a.numel() * a.element_size()
               for group in state["groups"] for a in leaves(group))


def _uniform_twin(cfg, params):
    """The uniform twin of a right-sized gemma3: (model, the parameters
    restacked into one (L, ...) dense group in layer order: each
    super-block's local units, its global unit, then the remainder)."""
    from repro_torch.models.lm import LM
    from repro_torch.tree import tree_map

    sb = params["group0"]
    rest = [params["group1"]] if "group1" in params else []

    def restack(loc, glob, *tail):
        return torch.cat([torch.cat([loc, glob[:, None]], 1).flatten(0, 1),
                          *tail])
    model = LM(dataclasses.replace(cfg, cache_mode="uniform"))
    out = {name: a for name, a in params.items()
           if not name.startswith("group")}
    out["group0"] = tree_map(restack, sb["loc"], sb["glob"], *rest)
    check([(g.kind, g.n) for g in model.groups] == [("dense", cfg.n_layers)],
          f"uniform twin's groups {model.groups}")
    return model, out


def _rs_serve(arch: str, card: str, seed: int) -> dict:
    """One right-sized gemma3 whole in bf16 (random weights from seed 0)
    at its published context: serve's 8 requests and one of
    ``long_prompt`` tokens through the engine (each prompt prefilled
    unpadded), the launches, peak memory, the decode state's bytes beside
    the uniform one's (from shapes), decode at batch 4 near the context's
    end with its profile and the caches' float32 upcast (the cast and
    the layout copy ``attn_decode``'s products read) timed alone,
    prefill by length with a profile of the longest, and the 2048-token
    prefill's logits through the kernels against the plain versions."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.lm import LM
    from repro_torch.serving import Request

    dev = _card()
    torch.cuda.empty_cache()
    context = RIGHTSIZED["context"][arch]
    cfg, model, params, init_s = _serve_model(torch.bfloat16, arch)
    n_attn = _attn_layers(model)
    tag = f"[rightsized] {arch}"
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        warm = torch.randint(0, cfg.vocab, (1, 128), generator=gen, device=dev)
        model.prefill(params, {"inputs": warm}, cache_len=256)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reqs = _serve_requests(cfg.vocab, RIGHTSIZED["new_tokens"])
        long = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                     RIGHTSIZED["long_prompt"])
        reqs.append(Request(uid=len(reqs), prompt=[int(t) for t in long],
                            max_new_tokens=RIGHTSIZED["new_tokens"]))
        run = _run_engine(model, params, reqs, cache_len=context)
        engine = run.pop("engine")
        peak = torch.cuda.max_memory_allocated()
        want = {op: 0 for op in run["launches"]}
        want.update(_flash_want(n_attn * len(reqs), "sm90"))
        check(run["launches"] == want,
              f"{tag}: launches {run['launches']} != {want} (one sm90 launch "
              f"an attention layer a prefill, each prompt prefilled whole)")
        check(all(len(r.generated) == RIGHTSIZED["new_tokens"]
                  for r in reqs),
              f"{tag}: a request stopped short of max_new_tokens")
        state_bytes = _state_bytes(engine.state)
        uniform = LM(dataclasses.replace(cfg, cache_mode="uniform"))
        uniform_bytes = _state_bytes(uniform.init_decode_state(
            SERVE["max_batch"], context, device="meta"))

        # decode at batch 4, every row near the end of the context
        state = engine.state
        state["index"] = torch.tensor(
            [context - 64 - 1000 * i for i in range(SERVE["max_batch"])],
            dtype=torch.int32, device=dev)
        toks = torch.randint(0, cfg.vocab, (SERVE["max_batch"], 1),
                             generator=gen, device=dev)
        ops.reset_launch_counts()

        def decode():
            nonlocal state
            _, state = model.decode_step(params, state, toks)
        decode_ms = _bare_ms(decode, 10)
        check(ops.launch_counts()["flash_attention"] == 0,
              f"{tag}: decode launched the flash kernel")
        decode_profile = _profile_steps(decode, 3)
        kv = [a for group in state["groups"] for a in _kv_leaves(group)]

        def upcast():
            # attn_decode's copies of every cache a step: the float32 cast,
            # then the (B, Hkv, S, Dh) layout its batched products read
            for a in kv:
                for layer in a.flatten(0, -5):
                    layer.float().transpose(1, 2).contiguous()
        upcast_ms = _time_ms(upcast, 5)
        del engine, state, kv

        prefill_ms = {}
        for t in RIGHTSIZED["prefill"]:
            tokens = torch.randint(0, cfg.vocab, (1, t), generator=gen,
                                   device=dev)
            ms = _bare_ms(lambda: model.prefill(
                params, {"inputs": tokens}, cache_len=context), 3)
            prefill_ms[t] = sorted(ms)[1]
        long_t = RIGHTSIZED["prefill"][-1]
        prefill_profile = _profile_call(lambda: model.prefill(
            params, {"inputs": tokens}, cache_len=context))

        tokens = torch.randint(0, cfg.vocab, (1, 2048), generator=gen,
                               device=dev)
        ops.reset_launch_counts()
        got, routes = _prefill_routed(model, params, tokens)
        check(ops.launch_counts() == {**want, **_flash_want(n_attn, "sm90")},
              f"{tag}: a 2048-token prefill launched {ops.launch_counts()}")
        check(got.shape == (1, cfg.vocab) and bool(torch.isfinite(got).all()),
              f"{tag}: prefill logits not finite or misshapen")
        held = _hold_kernel_in_prefill(
            model, params, tokens, got, routes,
            lambda top: BF16_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7),
            f"{tag} 2048-token prefill")
    med = sorted(decode_ms)[len(decode_ms) // 2]
    out = {"arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "groups": [(g.kind, g.n) for g in model.groups],
           "cuts": _cut_list(cfg), "dtype": "bfloat16", "init_s": init_s,
           "context": context, **run,
           "prompt_lengths": [len(r.prompt) for r in reqs],
           "peak_memory_bytes": peak, "state_bytes": state_bytes,
           "uniform_state_bytes": uniform_bytes,
           "decode_ms_batch4": decode_ms, "decode_profile": decode_profile,
           "upcast_ms": upcast_ms, "upcast_share_of_decode": upcast_ms / med,
           "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": {t: t / ms * 1e3
                                    for t, ms in prefill_ms.items()},
           f"prefill_{long_t}_profile": prefill_profile, "logits_2048": held}
    log(f"{tag} bf16, {cfg.n_layers} layers {out['groups']}, d "
        f"{cfg.d_model}, cut {out['cuts'] or 'none'}, context {context}: "
        f"init {init_s:.2f} s; engine {run['generated_tokens']} tokens for "
        f"{len(reqs)} requests (prompts {out['prompt_lengths']}, each "
        f"prefilled whole) in {run['wall_s']:.3f} s, {run['steps']} steps, "
        f"{run['tokens_per_s']:.1f} tokens/s; launches "
        f"{ {k: v for k, v in run['launches'].items() if v} }; peak memory "
        f"{peak / 2**30:.3f} GiB; decode state at batch "
        f"{SERVE['max_batch']}: {state_bytes / 1e9:.3f} GB right-sized, "
        f"{uniform_bytes / 1e9:.3f} GB uniform (from shapes) ({card})")
    log(f"{tag} decode at batch {SERVE['max_batch']}: {med:.3f} ms a step "
        f"median ({min(decode_ms):.3f}..{max(decode_ms):.3f}); the caches' "
        f"float32 upcast and layout copies alone {upcast_ms:.3f} ms = "
        f"{upcast_ms / med:.1%} of a step; profile of 3 steps: device busy "
        f"{decode_profile['busy_share']:.1%} of "
        f"{decode_profile['wall_us'] / 3e3:.3f} ms a step ({card})")
    for r in decode_profile["top"][:8]:
        log(f"{tag}   {r['us_per_round']:9.1f} us/step x"
            f"{r['launches_per_round']:.0f}  {r['kernel']}")
    for t, ms in prefill_ms.items():
        log(f"{tag} prefill {t:6d} tokens: {ms:.3f} ms ({t / ms * 1e3:,.0f} "
            f"tokens/s) ({card})")
    log(f"{tag} profile of a {long_t}-token prefill: device busy "
        f"{prefill_profile['device_busy_us'] / 1e3:.3f} ms = "
        f"{prefill_profile['busy_share']:.1%} of wall "
        f"{prefill_profile['wall_us'] / 1e3:.3f} ms; flash kernel "
        f"{prefill_profile['flash_us'] / 1e3:.3f} ms = "
        f"{prefill_profile['flash_share_of_device']:.1%} of device time "
        f"({card})")
    for r in prefill_profile["top"]:
        log(f"{tag}   {r['us']:10.1f} us x{r['launches']:<4d} {r['kernel']}")
    del params
    torch.cuda.empty_cache()
    return out


def _rs_twin(card: str) -> dict:
    """Right-sized against uniform on the same weights (gemma3-1b whole,
    bf16): a prompt past the window prefilled by both, logits bit-equal,
    then teacher-forced decode steps within ``RS_DECODE_TOL``; the rings
    wrap in the prefill and again in decode."""
    spec = RIGHTSIZED["twin"]
    dev = _card()
    torch.cuda.empty_cache()
    cfg, model, params, _ = _serve_model(torch.bfloat16, spec["arch"])
    umodel, uparams = _uniform_twin(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(61)
    tokens = torch.randint(0, cfg.vocab, (1, spec["prompt"]), generator=gen,
                           device=dev)
    tag = f"[rightsized twin] {spec['arch']}"
    check(spec["prompt"] > cfg.window, f"{tag}: the prompt must pass the "
          f"window")
    errs, agree = [], 0
    with torch.no_grad():
        rl, rs = model.prefill(params, {"inputs": tokens},
                               cache_len=spec["cache_len"])
        ul, us = umodel.prefill(uparams, {"inputs": tokens},
                                cache_len=spec["cache_len"])
        equal = torch.equal(rl, ul)
        check(equal, f"{tag}: prefill logits differ from the uniform twin's "
              f"by {_max_err(rl.float(), ul.float()):.3e}")
        tok = ul.argmax(-1, keepdim=True)
        for _ in range(spec["steps"]):
            rl, rs = model.decode_step(params, rs, tok)
            ul, us = umodel.decode_step(uparams, us, tok)
            errs.append(_max_err(rl.float(), ul.float())
                        / float(ul.float().abs().max()))
            agree += int(torch.equal(rl.argmax(-1), ul.argmax(-1)))
            tok = ul.argmax(-1, keepdim=True)
    ring = rs["groups"][0]["loc"]["pos"]
    out = {"arch": spec["arch"], "prompt": spec["prompt"],
           "cache_len": spec["cache_len"], "steps": spec["steps"],
           "prefill_logits_bit_equal": equal, "decode_rel_err": errs,
           "argmax_equal_steps": agree, "tolerance": RS_DECODE_TOL,
           "ring_slots": ring.shape[-1],
           "state_bytes": _state_bytes(rs), "uniform_state_bytes":
               _state_bytes(us)}
    log(f"{tag} bf16 whole, {spec['prompt']}-token prompt, cache_len "
        f"{spec['cache_len']}: prefill logits bit-equal to the uniform "
        f"twin's: {equal}; {spec['steps']} decode steps: largest |logit "
        f"difference| over max |logit| {max(errs):.3e} (tolerance "
        f"{RS_DECODE_TOL}), argmax equal at {agree} of {spec['steps']}; "
        f"rings of {out['ring_slots']} slots; state "
        f"{out['state_bytes'] / 1e6:.1f} MB against "
        f"{out['uniform_state_bytes'] / 1e6:.1f} MB ({card})")
    check(max(errs) <= RS_DECODE_TOL, f"{tag}: decode logits differ from the "
          f"uniform twin's by {max(errs):.3e} > {RS_DECODE_TOL}")
    del params, uparams
    torch.cuda.empty_cache()
    return out


def phase_rightsized(card: str) -> dict:
    """11e: gemma3-1b and gemma3-4b right-sized, whole, in bf16 through the
    engine at their published contexts and one loss step each; right-
    sized against uniform; the float32 twin's engine against isolated
    generation."""
    t0 = time.perf_counter()
    record = {"card": card}
    for i, arch in enumerate(RIGHTSIZED["archs"]):
        record[arch] = {"serve": _rs_serve(arch, card, 51 + i),
                        "loss": _recurrent_loss(arch, RIGHTSIZED,
                                                "rightsized loss", card)}
    record["twin"] = _rs_twin(card)
    record["serve_f32"] = _serve_f32(
        RIGHTSIZED["twin"]["arch"], "rightsized f32",
        new_tokens=RIGHTSIZED["f32_new_tokens"])
    record["seconds"] = time.perf_counter() - t0
    log(f"[rightsized] phase 11e on {card} took {record['seconds']:.1f} s")
    return record


# ---------------------------------------------------------------------------
# 11f-11h. LMs served over a mesh
# ---------------------------------------------------------------------------

MESH_DIR = ROOT / "chiprun_out" / "mesh_serving"
# (a) qwen1.5-110b at full width, 4 layers, bf16, a 4-way ("model",) mesh:
# a 2048-token batch-1 prefill and a batch-4 prefill of 512-token prompts,
# each then 8 teacher-forced decode steps (tokens from the seed, a cache
# of T + 8 slots; 32 until phase 14 came); (b) tinyllama whole in bf16 on
# (2 data, 2 model): SERVE's 8 requests through the engine, all 8 in its
# batch (its decode steps each gather the layers' FSDP weights through
# gloo, which the card's machine moves at ~0.1-0.2 GB/s: 8 slots halve the
# steps of SERVE's 4; 8 new tokens, SERVE's 64 cut to make room for 11g,
# 11h and 14), and
# the batch-4 prefill with 4 steps for the logits; (c) its float32 twin at
# 4 layers, the requests at 8 new tokens; (d) one NCCL rank (a 1 x 1
# mesh), tinyllama at 4 layers in bf16, SERVE's engine
B4 = (("b4", 4, 512),)
MESH_SERVE = dict(
    tag="mesh", dir=MESH_DIR, ranks=4, timeout_s=600, seed=7,
    parts={"qwen": dict(arch="qwen1.5-110b", n_layers=4, dtype="bfloat16",
                        mesh=((4,), ("model",)), engine=None, steps=8,
                        inputs=(("b1", 1, 2048), *B4), flash_parity=True),
           "tiny": dict(arch="tinyllama-1.1b", n_layers=None,
                        dtype="bfloat16", mesh=((2, 2), ("data", "model")),
                        engine=dict(max_batch=8, new_tokens=8), steps=4,
                        inputs=B4),
           "twin": dict(arch="tinyllama-1.1b", n_layers=4, dtype="float32",
                        mesh=((2, 2), ("data", "model")),
                        engine=dict(max_batch=8, new_tokens=8), steps=4,
                        inputs=B4)},
    one_rank={"tiny": dict(arch="tinyllama-1.1b", n_layers=4,
                           dtype="bfloat16",
                           engine=dict(max_batch=SERVE["max_batch"],
                                       new_tokens=SERVE["new_tokens"]),
                           steps=4, inputs=B4)},
    twin_tol=1e-4)
MESH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# 11g, the recurrent kinds over a mesh, as 11f: (a) mamba2-780m at full
# width, 4 of its 48 layers, bf16, a 4-way ("model",) mesh (12 SSD heads a
# rank): a 1 x 2048 and a 4 x 256 prefill, each then 4 teacher-forced
# decode steps; (b) recurrentgemma-2b at full width, 4 layers (a griffin
# super-block and a rec layer), bf16, (2 data, 2 model) (5 of the 10 q
# heads a rank, the KV head whole, half the RG-LRU width): a 4 x 512
# prefill and 4 steps, then 4 requests of 100-300 tokens, 8 new tokens
# each, through the engine; (c) its float32 twin, 4 new tokens; (d) one
# NCCL rank for each model at 4 layers in bf16 (the steps and new tokens
# halved to make room for phase 14)
RG_ENGINE = dict(max_batch=4, requests=4, min_prompt=100, max_prompt=300,
                 cache_len=512)
MESH_RECURRENT = dict(
    tag="mesh recurrent", dir=ROOT / "chiprun_out"
    / "mesh_recurrent", ranks=4, timeout_s=600, seed=7,
    parts={"mamba2": dict(arch="mamba2-780m", n_layers=4, dtype="bfloat16",
                          mesh=((4,), ("model",)), engine=None, steps=4,
                          inputs=(("b1", 1, 2048), ("b4", 4, 256))),
           "rg": dict(arch="recurrentgemma-2b", n_layers=4, dtype="bfloat16",
                      mesh=((2, 2), ("data", "model")),
                      engine=dict(RG_ENGINE, new_tokens=8), steps=4,
                      inputs=B4, flash_parity=True),
           "rg_twin": dict(arch="recurrentgemma-2b", n_layers=4,
                           dtype="float32", mesh=((2, 2), ("data", "model")),
                           engine=dict(RG_ENGINE, new_tokens=4), steps=4,
                           inputs=B4)},
    one_rank={name: dict(arch=arch, n_layers=4, dtype="bfloat16",
                         engine=dict(RG_ENGINE, new_tokens=8), steps=4,
                         inputs=(("b4", 4, 256),))
              for name, arch in (("mamba2", "mamba2-780m"),
                                 ("rg", "recurrentgemma-2b"))},
    twin_tol=1e-5)
# 11h, right-sized rings and cross attention over a mesh, as 11f: (a)
# gemma3-4b@rightsized at full width, 8 layers (a super-block of 5 local
# layers and the global one, and a remainder of 2 ring layers), bf16, a
# 4-way ("model",) mesh (2 q heads, 1 KV head and 256 of each 1024-slot
# ring a rank): a 1 x 2048 prefill (past the window: each ring keeps the
# last 1024 positions) and a 4 x 1020 prefill, whose 8 steps wrap the
# rings; (b) gemma3-1b@rightsized at full width, 8 layers, bf16, (2 data,
# 2 model) (its KV head whole): 4 requests of 300-700 tokens through the
# engine (some past the 512 window, each admitted unpadded), 4 new tokens
# each (8 until phase 14 came), and a 4 x 512 prefill with 4 steps; (c)
# its float32 twin; (d)
# whisper-tiny whole (4 encoder and 4 decoder layers), bf16, (2, 2) (3 of
# its 6 heads a rank): a 4 x 128 prefill over 4 x 1500 frames and 8
# steps, (e) its float32 twin; (f) llama-3.2-vision-90b at full width, 5
# layers (one vlm super-block of 4 self layers and the cross layer), bf16,
# ("model",) 4 (16 q and 2 KV heads a rank): a 1 x 2048 prefill over 1601
# vision tokens and 8 steps, its gates drawn as 11d's; (g) one NCCL rank
# for gemma3-1b@rightsized at 8 layers and whisper-tiny, in bf16
RS_MESH_ENGINE = dict(max_batch=4, requests=4, min_prompt=300,
                      max_prompt=700, cache_len=1024, new_tokens=4)
MESH_RINGS_CROSS = dict(
    tag="mesh rings cross", dir=ROOT / "chiprun_out" / "mesh_rings_cross",
    ranks=4, timeout_s=600, seed=7,
    parts={"gemma4b": dict(arch="gemma3-4b@rightsized", n_layers=8,
                           dtype="bfloat16", mesh=((4,), ("model",)),
                           engine=None, steps=8,
                           inputs=(("b1", 1, 2048), ("b4", 4, 1020)),
                           flash_parity=True),
           "gemma1b": dict(arch="gemma3-1b@rightsized", n_layers=8,
                           dtype="bfloat16", mesh=((2, 2), ("data", "model")),
                           engine=RS_MESH_ENGINE, steps=4, inputs=B4,
                           flash_parity=True),
           "gemma1b_twin": dict(arch="gemma3-1b@rightsized", n_layers=8,
                                dtype="float32",
                                mesh=((2, 2), ("data", "model")),
                                engine=RS_MESH_ENGINE, steps=4, inputs=B4),
           "whisper": dict(arch="whisper-tiny", n_layers=None,
                           dtype="bfloat16", mesh=((2, 2), ("data", "model")),
                           engine=None, steps=8, inputs=(("b4", 4, 128),),
                           flash_parity=True),
           "whisper_twin": dict(arch="whisper-tiny", n_layers=None,
                                dtype="float32",
                                mesh=((2, 2), ("data", "model")),
                                engine=None, steps=8,
                                inputs=(("b4", 4, 128),)),
           "vision": dict(arch="llama-3.2-vision-90b", n_layers=5,
                          dtype="bfloat16", mesh=((4,), ("model",)),
                          engine=None, steps=8, inputs=(("b1", 1, 2048),),
                          flash_parity=True)},
    one_rank={"gemma1b": dict(arch="gemma3-1b@rightsized", n_layers=8,
                              dtype="bfloat16", engine=RS_MESH_ENGINE,
                              steps=4, inputs=B4),
              "whisper": dict(arch="whisper-tiny", n_layers=None,
                              dtype="bfloat16", engine=None, steps=4,
                              inputs=(("b4", 4, 128),))},
    twin_tol=1e-4)
MESH_SPECS = {"11f": MESH_SERVE, "11g": MESH_RECURRENT,
              "11h": MESH_RINGS_CROSS}


def _mesh_model(part: dict):
    """(cfg, model, params from seed 0 on the card) of a part, as
    ``_cross_model`` draws them (a vlm's gates from ``CROSS["gates"]``)."""
    cfg, model, params, _, _ = _cross_model(
        part["arch"], MESH_DTYPES[part["dtype"]], part["n_layers"])
    return cfg, model, params


def _mesh_inputs(cfg, part: dict) -> dict:
    """name -> (prompt tokens (B, T), decode-step tokens (steps, B, 1),
    the memory's inputs: {"vision" or "audio_frames": standard normal
    float32 (B, S, width)} for a vlm or whisper, else {}) of a part's
    teacher-forced runs, numpy, from the 11f-11h seed."""
    rng = np.random.default_rng(MESH_SERVE["seed"])
    out = {}
    for name, b, t in part["inputs"]:
        toks = rng.integers(0, cfg.vocab, (b, t))
        steps = rng.integers(0, cfg.vocab, (part["steps"], b, 1))
        memory = {}
        if cfg.family == "vlm":
            memory["vision"] = rng.standard_normal(
                (b, cfg.vision_tokens, cfg.vision_dim), dtype=np.float32)
        elif cfg.family == "audio":
            memory["audio_frames"] = rng.standard_normal(
                (b, cfg.audio_frames, cfg.d_model), dtype=np.float32)
        out[name] = (toks, steps, memory)
    return out


@contextlib.contextmanager
def _flash_calls():
    """Record the (q shape, k shape, dtype, its keywords: causal and
    window) of every flash call inside the block (the call goes through
    unchanged)."""
    from repro_torch.kernels import ops

    calls, inner = [], ops.flash_attention

    def recorded(q, k, v, **kw):
        calls.append((list(q.shape), list(k.shape), str(q.dtype), kw))
        return inner(q, k, v, **kw)
    ops.flash_attention = recorded
    try:
        yield calls
    finally:
        ops.flash_attention = inner


def _forced(model, params, inputs: dict) -> dict:
    """Each input's prefill (a cache of T + steps slots; over its memory
    inputs too), then its teacher-forced decode steps, under no_grad: the
    logits of every call
    (steps + 1, B, V) in float32 on the host, the prefill's ms, launches
    and flash calls, ms a decode step, the launches of the steps and the
    bytes the mesh's collectives brought to this rank a step; the final
    state on the card."""
    from repro_torch.kernels import ops
    from repro_torch.sharding import tensor_parallel as tp

    dev = _card()
    out = {}
    for name, (toks, steps, memory) in inputs.items():
        toks = torch.from_numpy(toks).to(dev)
        steps = torch.from_numpy(steps).to(dev)
        batch = {"inputs": toks, **{key: torch.from_numpy(a).to(dev)
                                    for key, a in memory.items()}}
        cache_len = toks.shape[1] + steps.shape[0]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        tp.reset_moved_bytes()
        with torch.no_grad(), _flash_calls() as calls:
            t0 = time.perf_counter()
            logits, state = model.prefill(params, batch, cache_len=cache_len)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = {k: ops.launch_counts()[k] for k in NO_LM}
        prefill_moved = tp.moved_bytes()
        prefill_coll_s = tp.collective_seconds()
        got, ms = [logits], []
        ops.reset_launch_counts()
        tp.reset_moved_bytes()
        with torch.no_grad():
            for step in steps:
                t0 = time.perf_counter()
                logits, state = model.decode_step(params, state, step)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                got.append(logits)
        moved = tp.moved_bytes()
        coll_s = tp.collective_seconds()
        out[name] = {
            "logits": torch.stack(got).float().cpu(), "state": state,
            "state_bytes": _tree_bytes(dict(enumerate(state["groups"]))),
            "prefill_ms": prefill_ms, "decode_ms": ms,
            "decode_ms_median": _median(ms),
            "prefill_launches": prefill_launches,
            "prefill_flash_calls": calls,
            "prefill_moved_bytes": prefill_moved,
            "prefill_collective_ms": {k: v * 1e3
                                      for k, v in prefill_coll_s.items()},
            "collective_ms_per_step": {k: v * 1e3 / len(ms)
                                       for k, v in coll_s.items()},
            "decode_launches": {k: ops.launch_counts()[k] for k in NO_LM},
            "moved_bytes_per_step": {k: v / len(ms) for k, v in moved.items()}}
    return out


def _mesh_engine(model, params, spec: dict) -> dict:
    """``spec``'s requests (SERVE's where it names none) at its new
    tokens through the engine with its slots and cache (``_run_engine``):
    the token streams, tokens/s and the launches of the run."""
    reqs = _serve_requests(model.cfg.vocab, spec["new_tokens"],
                           spec if "requests" in spec else SERVE)
    run = _run_engine(model, params, reqs,
                      cache_len=spec.get("cache_len", SERVE["cache_len"]),
                      max_batch=spec["max_batch"])
    return {"streams": [r.generated for r in reqs],
            "tokens_per_s": run["tokens_per_s"], "wall_s": run["wall_s"],
            "steps": run["steps"], "launches": run["launches"]}


def _tree_bytes(tree) -> int:
    from repro_torch.tree import leaves

    return sum(a.numel() * a.element_size() for a in leaves(tree))


def _logits_errs(got, plain, yard) -> dict:
    """The mesh run's logits ``got`` and the no-mesh run's ``plain``
    against the float32 no-mesh yardstick ``yard`` (same weights): max
    abs errors, the bf16 tolerance 2 x the no-mesh error + 1 bf16 ulp of
    max |yard|, and the share of positions whose argmax agrees."""
    top = float(yard.abs().max())
    err, err_plain = _max_err(got, yard), _max_err(plain, yard)
    return {"max_abs_err": err, "plain_max_abs_err": err_plain,
            "tolerance": 2 * err_plain + 2.0 ** (math.floor(math.log2(top))
                                                 - 7),
            "max_abs_logit": top,
            "argmax_agree": float((got.argmax(-1) == yard.argmax(-1))
                                  .float().mean()),
            "plain_argmax_agree": float((plain.argmax(-1) == yard.argmax(-1))
                                        .float().mean()),
            "argmax_agree_plain": float((got.argmax(-1) == plain.argmax(-1))
                                        .float().mean())}


def _mesh_reference(name: str, part: dict, tmp: pathlib.Path) -> dict:
    """A part's runs in this process without a mesh: the teacher-forced
    logits in the part's dtype and (for bf16) of the same weights in
    float32 (the yardstick), and the engine's streams; saved to ``tmp``
    for the ranks, stats returned. Frees the card."""
    out = {}
    cfg, model, params = _mesh_model(part)
    inputs = _mesh_inputs(cfg, part)
    n_attn = _attn_layers(model)
    route = FLASH_ROUTE[cfg.dtype]
    plain = _forced(model, params, inputs)
    saved = {"plain": {k: r["logits"] for k, r in plain.items()}}
    for k, r in plain.items():
        check(r["prefill_launches"] == _flash_want(n_attn, route),
              f"mesh serving {name}: no-mesh prefill launches "
              f"{r['prefill_launches']}")
        out[k] = {"prefill_ms": r["prefill_ms"],
                  "decode_ms_median": r["decode_ms_median"]}
    del plain
    if part["engine"]:
        eng = _mesh_engine(model, params, part["engine"])
        saved["streams"] = eng["streams"]
        out["engine_tokens_per_s"] = eng["tokens_per_s"]
    out["param_bytes"] = _tree_bytes(params)
    if cfg.dtype == torch.bfloat16:
        # the yardstick: the same weights, upcast, in a float32 model
        import dataclasses

        f32 = dataclasses.replace(cfg, dtype=torch.float32,
                                  param_dtype=torch.float32)
        from repro_torch.models.lm import LM
        from repro_torch.tree import tree_map

        params = tree_map(lambda a: a.float(), params)
        torch.cuda.empty_cache()
        yard = _forced(LM(f32), params, inputs)
        saved["yard"] = {k: r["logits"] for k, r in yard.items()}
        del yard
    del params, model
    torch.cuda.empty_cache()
    torch.save(saved, tmp / f"{name}.pt")
    return out


def _draw_shard(part: dict, mesh, rank: int, ranks: int):
    """(cfg, model, this rank's serving shard of the part's weights from
    seed 0): the ranks draw the whole tree on the card one after another,
    each keeping its shard and freeing the rest before the next draws."""
    from repro_torch.sharding import rules

    for turn in range(ranks):
        if turn == rank:
            cfg, model, params = _mesh_model(part)
            local = rules.serving_shard(mesh, params)
            del params
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    return cfg, model, local


def mesh_serving_child(job_path: str, rank: int) -> int:
    """One rank of 11f, 11g or 11h (the job's ``phase``): each part's
    weights drawn and sharded, the teacher-forced runs (and the engine)
    under the part's mesh, gloo over CUDA tensors; writes its stats, its
    parameter and state bytes beside the layout's and its errors against
    the parent's no-mesh runs. Loads the flash kernels the parent
    built."""
    import hashlib

    from repro_torch.kernels import _build
    from repro_torch.launch.input_specs import param_shapes
    from repro_torch.launch.mesh import make_mesh, process_group
    from repro_torch.sharding import rules
    from repro_torch.sharding.ctx import use_mesh

    job = json.loads(pathlib.Path(job_path).read_text())
    spec = MESH_SPECS[job["phase"]]
    for stem in ("flash_attention_sm90", "flash_attention"):
        check(_build._target(_build.CSRC / f"{stem}.cu").exists(),
              f"mesh serving child: {stem}.cu is not built (the parent "
              f"builds it)")
    dev = _card()
    torch.cuda.set_device(dev)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // job["ranks"]))
    tmp = pathlib.Path(job["tmp"])
    out, meshes = {}, {}
    progress = open(pathlib.Path(job["out"]) / f"rank{rank}.log", "w")
    t_child = time.perf_counter()

    def note(what):
        progress.write(f"{time.perf_counter() - t_child:8.1f} s  {what}\n")
        progress.flush()
    with process_group(rank, job["ranks"], job["store"], backend="gloo",
                       timeout_s=job["timeout_s"]):
        for name, part in spec["parts"].items():
            shape, axes = part["mesh"]
            if (shape, axes) not in meshes:
                meshes[shape, axes] = make_mesh(shape, axes, "cuda")
            mesh = meshes[shape, axes]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            note(f"{name}: drawing")
            cfg, model, local = _draw_shard(part, mesh, rank, job["ranks"])
            draw_s = time.perf_counter() - t0
            note(f"{name}: drawn in {draw_s:.1f} s")
            draw_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            want = rules.shard_tree(mesh, param_shapes(cfg),
                                    rules.serving_param_spec)
            rec = {"param_bytes": _tree_bytes(local),
                   "layout_param_bytes": _tree_bytes(want),
                   "draw_s": draw_s, "draw_peak_bytes": draw_peak,
                   "attn_layers": _attn_layers(model)}
            torch.distributed.barrier()
            with use_mesh(mesh):
                runs = _forced(model, local, _mesh_inputs(cfg, part))
                note(f"{name}: forced runs " + ", ".join(
                    f"{k} prefill {r['prefill_ms']:.0f} ms (collectives "
                    f"{sum(r['prefill_collective_ms'].values()):.0f}), decode "
                    f"{r['decode_ms_median']:.1f} ms a step (collectives "
                    f"{sum(r['collective_ms_per_step'].values()):.1f})"
                    for k, r in runs.items()))
                if part["engine"]:
                    rec["engine"] = _mesh_engine(model, local, part["engine"])
                    note(f"{name}: engine {rec['engine']['wall_s']:.1f} s, "
                         f"{rec['engine']['steps']} steps")
            ref = torch.load(tmp / f"{name}.pt")
            for k, r in runs.items():
                got = r.pop("logits")
                rec[k] = {key: r[key] for key in r if key != "state"}
                b = {n: bb for n, bb, _ in part["inputs"]}[k]
                with use_mesh(None):
                    glob = model.init_decode_state(
                        b, r["state"]["cache_len"], device="meta")["groups"]
                rec[k]["layout_state_bytes"] = _tree_bytes(dict(enumerate(
                    rules.shard_tree(mesh, glob, rules.state_spec,
                                     batch=b))))
                rec[k]["logits_sha1"] = hashlib.sha1(
                    got.numpy().tobytes()).hexdigest()
                rec[k]["state_shapes"] = [
                    {path: list(a.shape) for path, a in _tree_paths(g)}
                    for g in r["state"]["groups"]]
                if "yard" in ref:
                    rec[k]["errs"] = _logits_errs(got, ref["plain"][k],
                                                  ref["yard"][k])
                else:
                    plain = ref["plain"][k]
                    top = float(plain.abs().max())
                    rec[k]["errs"] = {
                        "max_abs_err": _max_err(got, plain),
                        "max_abs_logit": top,
                        "tolerance": spec["twin_tol"] * top,
                        "argmax_agree": float((got.argmax(-1)
                                               == plain.argmax(-1))
                                              .float().mean())}
            if "streams" in ref:
                rec["engine"]["streams_equal"] = (rec["engine"]["streams"]
                                                  == ref["streams"])
                rec["engine"]["token_agree"] = float(np.mean(
                    [a == b for s, t in zip(rec["engine"]["streams"],
                                            ref["streams"])
                     for a, b in zip(s, t)]))
            rec["peak_bytes"] = torch.cuda.max_memory_allocated()
            if part.get("flash_parity") and rank == 0:
                rec["flash_parity"] = _mesh_flash_parity(runs)
            del local, runs, model
            out[name] = rec
            torch.distributed.barrier()
    (pathlib.Path(job["out"]) / f"rank{rank}.json").write_text(
        json.dumps(out, default=str))
    return 0


def _mesh_flash_parity(runs: dict) -> dict:
    """The flash kernel at each of a rank's distinct prefill calls (its q
    heads and the KV heads they read, the call's causality and window)
    against its plain version on the same random inputs; these launches
    are not counted in the runs."""
    from repro_torch.kernels import ops

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for name, r in runs.items():
        rows, seen = [], []
        for q_shape, k_shape, _, kw in r["prefill_flash_calls"]:
            if (q_shape, k_shape, kw) in seen:
                continue
            seen.append((q_shape, k_shape, kw))
            q, k, v = (torch.randn(shape, generator=gen, device=dev)
                       .to(torch.bfloat16)
                       for shape in (q_shape, k_shape, k_shape))
            got, want = (ops.flash_attention(q, k, v, impl=impl, **kw)
                         for impl in (None, "ref"))
            err = _max_err(got.float(), want.float())
            check(err <= FLASH_TOL[torch.bfloat16],
                  f"mesh serving: the flash kernel at {q_shape} / {k_shape} "
                  f"{kw} differs from its plain version by {err:.3e}")
            rows.append({"q": q_shape, "k": k_shape, **kw,
                         "max_abs_err": err})
        out[name] = rows
    return out


def _mesh_one_rank(card: str, spec: dict, name: str) -> dict:
    """(d) one NCCL rank, a 1 x 1 mesh: the spec's ``one_rank`` part
    ``name`` (a model at 4 layers in bf16), the teacher-forced runs and
    the engine bit-equal to the same runs without a mesh (logits, every
    state leaf, the streams)."""
    from repro_torch.launch.mesh import make_mesh, process_group
    from repro_torch.sharding import rules
    from repro_torch.sharding.ctx import use_mesh

    part = spec["one_rank"][name]
    cfg, model, params = _mesh_model(part)
    inputs = _mesh_inputs(cfg, part)
    engine = part["engine"]
    want = _forced(model, params, inputs)
    want_eng = engine and _mesh_engine(model, params, engine)
    with process_group(0, 1, spec["dir"] / f"store_one_{name}",
                       backend="nccl", timeout_s=120):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        local = rules.serving_shard(mesh, params)
        with use_mesh(mesh):
            got = _forced(model, local, inputs)
            got_eng = engine and _mesh_engine(model, local, engine)
    out = {}
    for k in inputs:
        g, w = got[k], want[k]
        check(torch.equal(g["logits"], w["logits"]),
              f"mesh serving (d) {k}: logits not bit-equal to no mesh")
        for gg, ww in zip(g["state"]["groups"], w["state"]["groups"]):
            gp, wp = _tree_paths(gg), _tree_paths(ww)
            check([p for p, _ in gp] == [p for p, _ in wp],
                  f"mesh serving (d) {k}: state leaves "
                  f"{[p for p, _ in gp]}, want {[p for p, _ in wp]}")
            for (path, ga), (_, wa) in zip(gp, wp):
                check(torch.equal(ga, wa),
                      f"mesh serving (d) {k}: state {path} not bit-equal")
        check(g["prefill_launches"] == w["prefill_launches"],
              f"mesh serving (d) {k}: launches {g['prefill_launches']}")
        out[k] = {"prefill_ms": g["prefill_ms"],
                  "plain_prefill_ms": w["prefill_ms"],
                  "decode_ms_median": g["decode_ms_median"],
                  "plain_decode_ms_median": w["decode_ms_median"],
                  "launches_per_prefill": g["prefill_launches"]}
    if engine:
        check(got_eng["streams"] == want_eng["streams"],
              "mesh serving (d): engine streams differ from no mesh")
        out["engine_tokens_per_s"] = got_eng["tokens_per_s"]
        out["plain_engine_tokens_per_s"] = want_eng["tokens_per_s"]
    del got, want, params, local, model
    torch.cuda.empty_cache()
    log(f"[{spec['tag']}] one NCCL rank, {cfg.arch_id} {cfg.n_layers} "
        f"layers bf16: logits and states" + (
            f" and {len(want_eng['streams'])} engine streams" if engine
            else "") + " bit-equal to no mesh" + (
            f"; engine {out['engine_tokens_per_s']:.1f} tokens/s (no mesh "
            f"{out['plain_engine_tokens_per_s']:.1f})" if engine else "")
        + f" on {card}")
    return out


def phase_mesh_serving(card: str, phase: str = "11f") -> dict:
    """11f: the dense kind served over a mesh (``sharding.ctx.use_mesh``);
    11g: the recurrent kinds; 11h: right-sized rings and the cross kinds
    (``MESH_SPECS``): the parts on 4 gloo ranks of the one card against
    the same weights without a mesh in this process, the ``one_rank``
    parts on one NCCL rank bit-equal."""
    import tempfile

    from repro_torch.launch.mesh import spawn

    spec = MESH_SPECS[phase]
    out_dir = spec["dir"]
    t_phase = time.perf_counter()
    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    record = {"card": card, "ranks": spec["ranks"],
              "one_rank": {name: _mesh_one_rank(card, spec, name)
                           for name in spec["one_rank"]}}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="mesh_serving_"))
    try:
        plain = {name: _mesh_reference(name, part, tmp)
                 for name, part in spec["parts"].items()}
        ranks = spec["ranks"]
        job = {"phase": phase, "ranks": ranks, "store": str(out_dir / "store"),
               "out": str(out_dir), "tmp": str(tmp),
               "timeout_s": spec["timeout_s"]}
        (out_dir / "job.json").write_text(json.dumps(job))
        t0 = time.perf_counter()
        spawn(lambda r: [sys.executable, str(ROOT / "chip_smoke.py"),
                         "--mesh-serving-child", str(out_dir / "job.json"),
                         str(r)], ranks, timeout_s=spec["timeout_s"])
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = [json.loads((out_dir / f"rank{r}.json").read_text())
           for r in range(ranks)]
    for name, part in spec["parts"].items():
        record[name] = _mesh_check_part(name, part, plain[name],
                                        [g[name] for g in got], card, spec)
    record["spawn_s"] = spawn_s
    record["seconds"] = time.perf_counter() - t_phase
    log(f"[{spec['tag']}] phase {phase} on {card} took "
        f"{record['seconds']:.1f} s (the ranks {spawn_s:.1f} s from spawn "
        f"to join)")
    return record


def _rank_heads(cfg, m: int) -> "tuple[int, int]":
    """(a rank's q heads on a ``model`` axis of ``m``: whole where they do
    not divide, the KV heads they read)."""
    hq = cfg.n_heads // m if cfg.n_heads % m == 0 else cfg.n_heads
    group = cfg.n_heads // cfg.n_kv_heads
    return hq, (cfg.n_kv_heads if hq == cfg.n_heads
                else (hq - 1) // group + 1)


def _kind_counts(pairs) -> dict:
    """The count of each (causal, window) of ``pairs`` ((causal, window
    or None), n), keyed "causal/window"."""
    out: dict = {}
    for key, n in pairs:
        if n:
            out[key] = out.get(key, 0) + n
    return {f"{c}/{w}": n for (c, w), n in sorted(
        out.items(), key=lambda kv: (kv[0][0], kv[0][1] or 0))}


def _flash_kinds(cfg) -> dict:
    """``_kind_counts`` of a prefill's flash calls (``_attn_layers``'
    count): a dense_sb super-block's local layers and a remainder of ring
    layers at the window, the global ones and every other causal layer
    without, whisper's encoder non-causal."""
    from repro_torch.models.lm import build_groups

    pairs = [((False, None), cfg.encoder_layers)]
    for g in build_groups(cfg):
        if g.kind == "dense_sb":
            pairs += [((True, cfg.window), g.n * cfg.local_per_global),
                      ((True, None), g.n)]
        elif g.kind in ("dense", "moe"):
            pairs += [((True, w or None), 1) for w in g.windows]
        elif g.kind == "griffin":
            pairs.append(((True, cfg.window), g.n))
        elif g.kind in ("vlm", "dec"):
            pairs.append(((True, None), g.n * (cfg.cross_attn_every
                                               if g.kind == "vlm" else 1)))
    return _kind_counts(pairs)


def _call_kinds(calls) -> dict:
    """``_kind_counts`` of recorded flash calls."""
    return _kind_counts(((kw.get("causal", True), kw.get("window") or None),
                         1) for _, _, _, kw in calls)


def _mesh_check_part(name: str, part: dict, plain: dict, ranks: list,
                     card: str, spec: dict = MESH_SERVE) -> dict:
    """Check one part's ranks: parameter and decode-state bytes as the
    layout's, logits bit-equal across ranks and within the part's
    tolerance, each prefill's flash launches on the route at the rank's
    heads (none for mamba2), no launch in a decode step, the engine's
    streams (equal to no mesh for float32); log the times, bytes and
    memory."""
    from repro_torch.configs import get_config

    dtype = MESH_DTYPES[part["dtype"]]
    cfg = get_config(part["arch"])
    layers = part["n_layers"] or cfg.n_layers
    sizes = dict(zip(part["mesh"][1], part["mesh"][0]))
    m = sizes["model"]
    route = FLASH_ROUTE[dtype]
    tag = spec["tag"]
    label = f"{tag} ({name})"
    n_attn = ranks[0]["attn_layers"]
    for r, rec in enumerate(ranks):
        check(rec["param_bytes"] == rec["layout_param_bytes"],
              f"{label}: rank {r} holds {rec['param_bytes']} parameter bytes, "
              f"its serving shard {rec['layout_param_bytes']}")
        for k, _, _ in part["inputs"]:
            check(rec[k]["state_bytes"] == rec[k]["layout_state_bytes"],
                  f"{label} {k}: rank {r} holds {rec[k]['state_bytes']} "
                  f"decode-state bytes, its shard "
                  f"{rec[k]['layout_state_bytes']}")
    out = {"arch": part["arch"], "n_layers": layers, "dtype": part["dtype"],
           "mesh": sizes, "plain": plain,
           "param_bytes_per_rank": [r["param_bytes"] for r in ranks],
           "plain_param_bytes": plain["param_bytes"],
           "peak_bytes_per_rank": [r["peak_bytes"] for r in ranks],
           "draw_peak_bytes_per_rank": [r["draw_peak_bytes"] for r in ranks],
           "draw_s_per_rank": [r["draw_s"] for r in ranks]}
    for k, b, t in part["inputs"]:
        rows = [rec[k] for rec in ranks]
        check(len({r["logits_sha1"] for r in rows}) == 1,
              f"{label} {k}: the ranks' logits differ")
        errs = rows[0]["errs"]
        check(errs["max_abs_err"] <= errs["tolerance"],
              f"{label} {k}: logits {errs['max_abs_err']:.4e} from the "
              f"yardstick > tolerance {errs['tolerance']:.4e}")
        # the rank's batch rows, q heads (whole where they do not divide
        # over model) and the KV heads they read; a causal call over the
        # prompt, whisper's encoder's non-causal over its frames
        n_data = sizes.get("data", 1)
        hq, kv = _rank_heads(cfg, m)
        rows_b = b // n_data if b % n_data == 0 else b
        kinds = _flash_kinds(dataclasses.replace(cfg, n_layers=layers))
        for r, row in enumerate(rows):
            calls = row["prefill_flash_calls"]
            check(row["prefill_launches"] == _flash_want(n_attn, route),
                  f"{label} {k}: rank {r} prefill launches "
                  f"{row['prefill_launches']}, want {n_attn} on {route}")
            check(all(c[0] == [rows_b, t if c[3].get("causal", True)
                               else cfg.audio_frames, hq, cfg.head_dim]
                      and c[1][2] == kv for c in calls),
                  f"{label} {k}: rank {r} flash calls {calls[:1]}, want q "
                  f"[{rows_b}, {t}, {hq}, {cfg.head_dim}] and {kv} KV heads")
            check(_call_kinds(calls) == kinds,
                  f"{label} {k}: rank {r} flash calls by (causal, window) "
                  f"{_call_kinds(calls)}, want {kinds}")
            check(all(v == 0 for v in row["decode_launches"].values()),
                  f"{label} {k}: rank {r} decode launched "
                  f"{row['decode_launches']}")
        moved = rows[0]["moved_bytes_per_step"]
        calls = rows[0]["prefill_flash_calls"]
        out[k] = {"errs": errs,
                  "prefill_ms": [r["prefill_ms"] for r in rows],
                  "decode_ms_median": [r["decode_ms_median"] for r in rows],
                  "moved_bytes_per_decode_step": moved,
                  "collective_ms_per_decode_step": [
                      r["collective_ms_per_step"] for r in rows],
                  "prefill_moved_bytes": rows[0]["prefill_moved_bytes"],
                  "flash_call": calls[0][:2] if calls else None,
                  "launches_per_prefill": rows[0]["prefill_launches"],
                  "state_bytes": [r["state_bytes"] for r in rows],
                  "state_shapes": rows[0]["state_shapes"]}
        coll = out[k]["collective_ms_per_decode_step"]
        log(f"[{tag}] ({name}) {part['arch']} {layers} layers {part['dtype']} "
            f"on {sizes}, {k} ({b} x {t}): prefill "
            + " / ".join(f"{x:.1f}" for x in out[k]["prefill_ms"])
            + " ms, decode " + " / ".join(f"{x:.2f}" for x in
                                          out[k]["decode_ms_median"])
            + f" ms a step by rank (no mesh {plain[k]['prefill_ms']:.1f} / "
            f"{plain[k]['decode_ms_median']:.2f} ms); "
            f"{sum(moved.values()) / 1e6:.3f} MB through the collectives a "
            f"decode step a rank ({ {kk: int(v) for kk, v in moved.items()} }"
            f"), " + " / ".join(f"{sum(c.values()):.1f}" for c in coll)
            + " ms of it in them by rank; decode state "
            + " / ".join(f"{x / 1e6:.3f}" for x in out[k]["state_bytes"])
            + " MB a rank (the layout's); "
            + (f"flash q {calls[0][0]} k {calls[0][1]} x{n_attn} a prefill "
               f"a rank" if calls else "no flash call"))
        log(f"[{tag}]   logits vs the float32 no-mesh yardstick: max abs err "
            f"{errs['max_abs_err']:.4e} (tolerance {errs['tolerance']:.4e}"
            + (f", no-mesh {part['dtype']} {errs['plain_max_abs_err']:.4e}"
               if "plain_max_abs_err" in errs else "")
            + f", max |logit| {errs['max_abs_logit']:.3f}); argmax agrees "
            f"at {errs['argmax_agree']:.4f} of positions"
            + (f" (no mesh {errs['plain_argmax_agree']:.4f}; with the "
               f"no-mesh run {errs['argmax_agree_plain']:.4f})"
               if "plain_argmax_agree" in errs else ""))
    if part["engine"]:
        eng = ranks[0]["engine"]
        check(all(r["engine"]["streams"] == eng["streams"] for r in ranks),
              f"{label}: the ranks' engine streams differ")
        espec = part["engine"]
        reqs = espec.get("requests", SERVE["requests"])
        for r, rec in enumerate(ranks):
            fl = rec["engine"]["launches"]
            check(fl["flash_attention"] == reqs * n_attn
                  and fl[f"flash_attention_{route}"] == reqs * n_attn,
                  f"{label}: rank {r} engine launches {fl}, want "
                  f"{reqs} prefills x {n_attn} on {route}")
        if dtype == torch.float32:
            check(eng["streams_equal"],
                  f"{label}: engine streams differ from no mesh")
        out["engine"] = {k: eng[k] for k in ("tokens_per_s", "wall_s", "steps",
                                             "streams_equal", "token_agree")}
        out["engine"]["tokens_per_s_by_rank"] = [
            r["engine"]["tokens_per_s"] for r in ranks]
        log(f"[{tag}] ({name}) engine, {reqs} requests x "
            f"{espec['new_tokens']} new tokens, {espec['max_batch']} slots: "
            + " / ".join(
                f"{x:.1f}" for x in out["engine"]["tokens_per_s_by_rank"])
            + f" tokens/s by rank (no mesh "
            f"{plain['engine_tokens_per_s']:.1f}); streams equal to no mesh: "
            f"{eng['streams_equal']} ({eng['token_agree']:.4f} of tokens "
            f"agree)")
    if part.get("flash_parity"):
        out["flash_parity"] = ranks[0]["flash_parity"]
    log(f"[{tag}] ({name}) parameter bytes a rank "
        + " / ".join(f"{b / 1e9:.3f}" for b in out["param_bytes_per_rank"])
        + f" GB (the layout's; whole {plain['param_bytes'] / 1e9:.3f} GB), "
        f"peak device memory a rank serving " + " / ".join(
            f"{b / 2**30:.2f}" for b in out["peak_bytes_per_rank"])
        + " GiB, drawing the weights in turn " + " / ".join(
            f"{b / 2**30:.2f}" for b in out["draw_peak_bytes_per_rank"])
        + f" GiB; 4 ranks share one card and gloo stages through the host, "
        f"so these times say nothing of 4 cards; on {card}")
    return out


# ---------------------------------------------------------------------------
# 11. flash times
# ---------------------------------------------------------------------------

FLASH_TIMED = [  # (route, label, dtype, B, T, H, Hkv, D, window, causal)
    ("sm90", "TinyLlama prefill (1, 2048, 32, 4, 64) bf16 causal",
     torch.bfloat16, 1, 2048, 32, 4, 64, None, True),
    ("sm90", "gemma3-1b local (1, 2048, 4, 1, 256) bf16 window 512",
     torch.bfloat16, 1, 2048, 4, 1, 256, 512, True),
    ("sm90", "qwen1.5 heads (1, 2048, 64, 8, 128) bf16 causal",
     torch.bfloat16, 1, 2048, 64, 8, 128, None, True),
    ("sm90", "recurrentgemma local (1, 2048, 10, 1, 256) bf16 window 2048",
     torch.bfloat16, 1, 2048, 10, 1, 256, 2048, True),
    ("sm90", "arctic heads (1, 2048, 56, 8, 128) bf16 causal",
     torch.bfloat16, 1, 2048, 56, 8, 128, None, True),
    # TMA fills D = 112 to the kernel's 128 with zeros: the bound counts
    # the function's own 112
    ("sm90", "kimi-k2 heads (1, 2048, 64, 8, 112) bf16 causal",
     torch.bfloat16, 1, 2048, 64, 8, 112, None, True),
    # whisper's encoder: every query sees all 1500 keys
    ("sm90", "whisper encoder (1, 1500, 6, 6, 64) bf16 non-causal",
     torch.bfloat16, 1, 1500, 6, 6, 64, None, False),
    # gemma3-4b: a local layer, and a global one at the 32,768-token prompt
    ("sm90", "gemma3-4b local (1, 2048, 8, 4, 256) bf16 window 1024",
     torch.bfloat16, 1, 2048, 8, 4, 256, 1024, True),
    ("sm90", "gemma3-4b global (1, 32768, 8, 4, 256) bf16 causal",
     torch.bfloat16, 1, 32768, 8, 4, 256, None, True),
    ("tf32x3", "TinyLlama prefill (1, 2048, 32, 4, 64) f32 causal",
     torch.float32, 1, 2048, 32, 4, 64, None, True),
    ("tf32x3", "qwen1.5 heads (1, 2048, 64, 8, 128) f32 causal",
     torch.float32, 1, 2048, 64, 8, 128, None, True),
    ("tf32x3", "gemma3-1b local (1, 2048, 4, 1, 256) f32 window 512",
     torch.float32, 1, 2048, 4, 1, 256, 512, True),
    ("tf32x3", "whisper encoder (1, 1500, 6, 6, 64) f32 non-causal",
     torch.float32, 1, 1500, 6, 6, 64, None, False),
]


# past this length SDPA is given K and V repeated to every query head
# (outside the timed call): its GQA path is not bound to a fused backend,
# and the math backend's (T, T) logits for every head would not fit
SDPA_GQA_MAX_T = 8192


def _sdpa_inputs(q, k, v):
    """(q, k, v) with heads second for F.scaled_dot_product_attention, and
    whether to pass ``enable_gqa`` (K and V repeated to every query head
    past ``SDPA_GQA_MAX_T``)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.shape[1] <= SDPA_GQA_MAX_T:
        return qt, kt, vt, True
    group = q.shape[2] // k.shape[2]
    return (qt, kt.repeat_interleave(group, dim=1),
            vt.repeat_interleave(group, dim=1), False)


def _visible_pairs(t: int, window, causal: bool = True) -> int:
    """Query-key pairs a self-attention of length t computes: causal
    (windowed) rows see their past, a non-causal row all t keys."""
    if not causal:
        return t * t
    rows = torch.arange(t, dtype=torch.int64)
    lo = (rows - window + 1).clamp(min=0) if window else torch.zeros_like(rows)
    return int((rows - lo + 1).sum())


def _device_kernels_ms(fn, reps: int) -> dict:
    """Device time of each kernel ``fn`` launches, ms per call, from the
    profiler: free of the host dispatch that back-to-back event timing
    measures when a kernel is shorter than its launch path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.self_device_time_total / reps / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def _device_ms(fn, reps: int) -> float:
    """Device time of the kernels ``fn`` launches, ms per call."""
    return sum(_device_kernels_ms(fn, reps).values())


def phase_flash_times() -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False  # SDPA in float32
    torch.backends.cudnn.allow_tf32 = False
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(8)
    out = {f"flash_attention_{route}": [] for route in FLASH_ROUTE.values()}
    for route, label, dtype, b, t, h, hkv, d, window, causal in FLASH_TIMED:
        q, k, v = _flash_inputs(gen, b, t, t, h, hkv, d, dtype, dev)
        qt, kt, vt, gqa = _sdpa_inputs(q, k, v)
        if window:
            pos = torch.arange(t, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & (
                pos[None, :] > pos[:, None] - window)

            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=gqa)
        else:
            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=gqa)

        def kern():
            return ops.flash_attention(q, k, v, causal=causal, window=window,
                                       impl="cuda")

        def plain():
            return ops.flash_attention(q, k, v, causal=causal, window=window,
                                       impl="ref")
        item = q.element_size()
        io = (2 * q.numel() + k.numel() + v.numel()) * item
        flops = 4 * d * h * b * _visible_pairs(t, window, causal)
        bound, bound_by = _bound_ms(io, 0, flops, dtype)
        simt_bound = None
        if route == "tf32x3":
            # the least time for its work: three TF32 tensor-core products
            # for each float32 one, under the float32 SIMT bound
            simt_bound = bound
            bound, bound_by = _bound_ms(io, 0, 3 * flops, dtype,
                                        TF32_OPS_PER_S)
        ops.reset_launch_counts()
        got = kern()
        check(ops.launch_counts()[f"flash_attention_{route}"] == 1,
              f"flash times {label}: not on the {route} kernel")
        row = dict(shape=label, dims=[b, t, h, hkv, d], window=window,
                   causal=causal,
                   ms=_time_ms(kern, 20), plain_ms=_time_ms(plain, 5),
                   library_ms=_time_ms(lib, 20),
                   device_ms=_device_ms(kern, 20),
                   library_device_ms=_device_ms(lib, 20),
                   library=("F.scaled_dot_product_attention(enable_gqa="
                            "True)" if gqa else "F.scaled_dot_product_"
                            "attention on K, V repeated to H heads"),
                   bound_ms=bound, bound_by=bound_by, gflop=flops / 1e9,
                   simt_bound_ms=simt_bound,
                   max_abs_err=_max_err(got.float(), plain().float()),
                   library_max_abs_err=_max_err(
                       got.float(), lib().transpose(1, 2).float()))
        out[f"flash_attention_{route}"].append(row)
        peak = (f" at 3xTF32 on the tensor cores, FP32 SIMT bound "
                f"{simt_bound:.4f}" if simt_bound else "")
        log(f"[flash times] {label} ({route}): {row['ms']:.4f} ms, device "
            f"{row['device_ms']:.4f} (bound {bound:.4f} by {bound_by}{peak}, "
            f"{flops / 1e9:.2f} GFLOP; plain {row['plain_ms']:.4f}; SDPA "
            f"{row['library_ms']:.4f}, device {row['library_device_ms']:.4f}); "
            f"max abs err vs plain {row['max_abs_err']:.3e}, vs SDPA "
            f"{row['library_max_abs_err']:.3e}")
    return out


# ---------------------------------------------------------------------------
# 13. train: LM training through the flash-attention backward kernel
# ---------------------------------------------------------------------------

# (a) the backward kernels against their plain version: (label, (B, T, H,
# Hkv, D), window, causal); the training shape fourth (the kernels line's
# row), recurrentgemma's local attention fifth (a group of 10 heads cut
# into runs), a head dim that is not a multiple of 8 sixth (the tf32x3
# route in bf16 too), then arctic's and kimi-k2's heads, and whisper's
# encoder, non-causal over 1500 frames (every query tile for each key tile)
FLASH_BWD_SHAPES = [
    ("TinyLlama heads (1, 2048, 32, 4, 64) causal", (1, 2048, 32, 4, 64),
     None, True),
    ("qwen1.5 heads (1, 2048, 64, 8, 128) causal", (1, 2048, 64, 8, 128),
     None, True),
    ("gemma3-1b local (1, 2048, 4, 1, 256) window 512", (1, 2048, 4, 1, 256),
     512, True),
    ("TinyLlama training (2, 2048, 32, 4, 64) causal", (2, 2048, 32, 4, 64),
     None, True),
    ("recurrentgemma local (1, 2048, 10, 1, 256) window 2048",
     (1, 2048, 10, 1, 256), 2048, True),
    ("head dim 60 (1, 1024, 8, 2, 60) causal", (1, 1024, 8, 2, 60), None,
     True),
    # arctic's heads (a group of 7, cut into 7 runs) and kimi-k2's (D 112)
    ("arctic heads (1, 2048, 56, 8, 128) causal", (1, 2048, 56, 8, 128),
     None, True),
    ("kimi-k2 heads (1, 2048, 64, 8, 112) causal", (1, 2048, 64, 8, 112),
     None, True),
    ("whisper encoder (1, 1500, 6, 6, 64) non-causal", (1, 1500, 6, 6, 64),
     None, False),
    ("gemma3-4b local (1, 2048, 8, 4, 256) window 1024",
     (1, 2048, 8, 4, 256), 1024, True)]
# bf16 only: gemma3-4b's global layer at its 32,768-token prompt (the plain
# version's gradient by query blocks, SDPA on K and V repeated to every head)
FLASH_BWD_LONG = [("gemma3-4b global (1, 32768, 8, 4, 256) causal",
                   (1, 32768, 8, 4, 256), None, True)]
TRAIN_SHAPE = 3  # FLASH_BWD_SHAPES' index of the training shape
# the largest |error| of each gradient over its largest |value|: bfloat16
# 2e-2 (the wgmma forward's P V in bfloat16, the sm90 backward's P and dS
# rounded to bfloat16 as wgmma operands, each gradient rounded to
# bfloat16), float32 1e-4 (the 3xTF32 forward's output and log-sum-exp,
# the 3xTF32 backward)
FLASH_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
TRAIN = dict(arch="tinyllama-1.1b", batch=2, seq=2048, steps=12, lr=3e-3,
             seed=0, f32_layers=4)
# the kernels' run against the plain versions' from the same init and
# batches: |CE difference| at each step over the plain CE, each gradient
# leaf of step 0 by its relative norm error. bfloat16: the two forwards
# round at other places (P V in bf16 in the wgmma kernel) and the
# differences grow through 22 layers and the steps; float32 (TF32 off):
# the kernels' float32 sums in their own order (the 3xTF32 forward within
# 2e-5 of its output), equal CE at the first steps, then grown by
# AdamW's normalised steps over a loss that spikes (1.8e-5 at step 9 on
# an H100)
TRAIN_TOL = {torch.bfloat16: {"ce": 1e-2, "grad": 5e-2},
             torch.float32: {"ce": 1e-4, "grad": 1e-4}}
HEAD = dict(m=8, per_client=64, seq=32, k=64, rounds=10, lam=1e-3)


def _bwd_splits(route, b, t, h, hkv, d) -> int:
    """The runs of heads the route's dk/dv kernel cuts a group into."""
    from repro_torch.kernels import flash_attention as kflash

    rule = (kflash.bwd_sm90_splits if route == "sm90"
            else kflash.bwd_tf32x3_splits)
    return rule(b, t, h, hkv, d)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _plain_grad_by_query_blocks(q, k, v, do, causal, window,
                                rows: int = 2048):
    """``ref.mha_blocked_grad`` in float32 over blocks of ``rows`` queries
    (causal: each block's keys up to its last query), dk and dv summed
    over the blocks in float32, each gradient cast to q's dtype: the plain
    version at a length whose whole autograd graph would not fit (every
    key block's float32 logits for all queries kept for the backward)."""
    from repro_torch.kernels import ref

    t, tk = q.shape[1], k.shape[1]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for s in range(0, t, rows):
        e = min(t, s + rows)
        end = e if causal else tk
        gq, gk, gv = ref.mha_blocked_grad(
            q[:, s:e].float(), k[:, :end].float(), v[:, :end].float(),
            do[:, s:e].float(), causal=causal, window=window, q_offset=s)
        dq[:, s:e] = gq
        dk[:, :end] += gk
        dv[:, :end] += gv
    return tuple(g.to(q.dtype) for g in (dq, dk, dv))


def _flash_bwd_row(label, dims, window, causal, dtype, gen, dev) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops, ref

    b, t, h, hkv, d = dims
    q, k, v = _flash_inputs(gen, b, t, t, h, hkv, d, dtype, dev)
    do = torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype)
    out, lse = kflash._forward(q, k, v, causal=causal, window=window,
                               q_offset=0, block_k=1024, with_lse=True)
    check(torch.equal(out, kflash.flash_attention_cuda(
              q, k, v, causal=causal, window=window)),
          f"flash backward {label}: the forward's output changes when it "
          f"writes its log-sum-exp")

    def kern():
        return kflash.flash_attention_bwd_cuda(q, k, v, out, do, lse,
                                               causal=causal, window=window)

    def plain():
        if t > SDPA_GQA_MAX_T:
            return _plain_grad_by_query_blocks(q, k, v, do, causal, window)
        return ref.mha_blocked_grad(q, k, v, do, causal=causal,
                                    window=window)
    route = kflash.flash_bwd_route(dtype, d)
    splits = _bwd_splits(route, b, t, h, hkv, d)
    ops.reset_launch_counts()
    got = kern()
    counts = {op: n for op, n in ops.launch_counts().items()
              if op.startswith("flash_attention_bwd")}
    name = str(dtype).split(".")[-1]
    check(counts == {**NO_BWD, "flash_attention_bwd": 1,
                     f"flash_attention_bwd_{route}": 1,
                     f"flash_attention_bwd_{route}_sum": int(splits > 1),
                     **{f"flash_attention_bwd_{k}": 1
                        for k in BWD_ROUTE_KERNELS[route]}},
          f"flash backward {name} {label}: launches {counts} are not one "
          f"call of the {route} route's kernels")
    again, want = kern(), plain()
    torch.cuda.synchronize()
    rel = {g: _rel_err(x, w) for g, x, w in zip(("dq", "dk", "dv"), got, want)}
    abs_err = max(_max_err(x.float(), w.float()) for x, w in zip(got, want))
    check(max(rel.values()) <= FLASH_BWD_TOL[dtype],
          f"flash backward {name} {label}: kernel differs from the plain "
          f"version by {rel} of max |grad| > {FLASH_BWD_TOL[dtype]}")
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"flash backward {name} {label}: a second call differs")
    # the yardstick: SDPA's backward on the same inputs (heads second)
    qt, kt, vt, gqa = _sdpa_inputs(q, k, v)
    qt, kt, vt = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    if window:
        pos = torch.arange(t, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & (
            pos[None, :] > pos[:, None] - window)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 enable_gqa=gqa)
    else:
        lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal,
                                                 enable_gqa=gqa)
    do_t = do.transpose(1, 2)

    def lib():
        return torch.autograd.grad(lib_out, (qt, kt, vt), do_t,
                                   retain_graph=True)
    # q, o, dO read and dq written; k, v read and dk, dv written; lse read
    io = (4 * q.numel() + 4 * k.numel()) * q.element_size() + lse.numel() * 4
    # five products (S, dP, dV, dK, dQ) of 2 D flops a visible pair a head
    flops = 10 * d * h * b * _visible_pairs(t, window, causal)
    bound, bound_by = _bound_ms(io, 0, flops, dtype)
    simt_bound = None
    if dtype == torch.float32:
        simt_bound = bound
        bound, bound_by = _bound_ms(io, 0, 3 * flops, dtype, TF32_OPS_PER_S)
    by_kernel = _device_kernels_ms(kern, 10)
    row = dict(shape=f"{label} {name}", dims=list(dims), window=window,
               causal=causal, dtype=name, route=route, splits=splits, rel_err=rel,
               max_abs_err=abs_err, ms=_time_ms(kern, 10), device_ms=sum(by_kernel.values()),
               device_ms_by_kernel=by_kernel, plain_ms=_time_ms(plain, 2),
               library=("SDPA backward (enable_gqa=True)" if gqa else
                        "SDPA backward on K, V repeated to H heads"),
               library_ms=_time_ms(lib, 10),
               library_device_ms=_device_ms(lib, 10), bound_ms=bound,
               bound_by=bound_by, simt_bound_ms=simt_bound,
               gflop=flops / 1e9)
    split = ", ".join(f"{re.split(r'[<(]', key.split('::')[-1])[0]} "
                      f"{ms:.3f}" for key, ms in by_kernel.items())
    peak = (f" at 3xTF32, FP32 SIMT bound {simt_bound:.4f}" if simt_bound
            else "")
    runs = f", {splits} runs of heads"
    log(f"[train] flash backward {row['shape']} ({route}{runs}): rel err dq "
        f"{rel['dq']:.2e} dk {rel['dk']:.2e} dv {rel['dv']:.2e} (tol "
        f"{FLASH_BWD_TOL[dtype]}); {row['ms']:.4f} ms, device "
        f"{row['device_ms']:.4f} ({split}); bound {bound:.4f} by {bound_by}"
        f"{peak}, {flops / 1e9:.1f} GFLOP; plain {row['plain_ms']:.3f}; SDPA "
        f"backward {row['library_ms']:.4f}, device "
        f"{row['library_device_ms']:.4f}")
    return row


def _flash_bwd_no_fallback(dev) -> None:
    """Each backward route with its entry point made to fail raises, and
    launches nothing of either route: no fallback."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as kflash

    class Failing:  # every backward entry point reports cudaErrorInvalidValue
        def __init__(self, lib):
            self.repro_error_string = lib.repro_error_string

        def __getattr__(self, name):
            return lambda *args: 1

    gen = torch.Generator(device=dev).manual_seed(16)
    real = _build.library
    for dtype, d in ((torch.bfloat16, 64), (torch.float32, 64),
                     (torch.bfloat16, 60)):
        route = kflash.flash_bwd_route(dtype, d)
        q, k, v = _flash_inputs(gen, 1, 128, 128, 4, 2, d, dtype, dev)
        out, lse = kflash._forward(q, k, v, causal=True, window=None,
                                   q_offset=0, block_k=1024, with_lse=True)
        _build.library = lambda stem="srht": (
            Failing(real(stem)) if stem.startswith("flash_attention_bwd")
            else real(stem))
        ops.reset_launch_counts()
        try:
            kflash.flash_attention_bwd_cuda(q, k, v, out, q, lse)
            raised = False
        except RuntimeError as err:
            raised = f"({route})" in str(err)
        finally:
            _build.library = real
        counts = {op: n for op, n in ops.launch_counts().items() if n}
        check(raised and not counts, f"flash backward {dtype} d {d}: a "
              f"failing {route} kernel raised {raised}, launches {counts} "
              f"(no fallback allowed)")
    log("[train] flash backward: a failing sm90 or tf32x3 entry point "
        "raises (bf16 d 64; f32 d 64 and bf16 d 60), nothing falls back to "
        "the other route")


def phase_flash_bwd() -> dict:
    """(a): the backward kernels at their five shapes in both dtypes, the
    no-fallback check, and the forward with its log-sum-exp written
    bit-equal to the forward without over flash parity's self-attention
    shapes."""
    from repro_torch.kernels import flash_attention as kflash

    torch.backends.cuda.matmul.allow_tf32 = False  # SDPA in float32
    torch.backends.cudnn.allow_tf32 = False
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = [_flash_bwd_row(label, dims, window, causal, dtype, gen, dev)
            for dtype in FLASH_BWD_TOL
            for label, dims, window, causal in FLASH_BWD_SHAPES]
    rows += [_flash_bwd_row(label, dims, window, causal, torch.bfloat16, gen,
                            dev)
             for label, dims, window, causal in FLASH_BWD_LONG]
    _flash_bwd_no_fallback(dev)
    swept = 0
    for dtype in FLASH_BWD_TOL:
        cases = [(t, h, hkv, d, None, True) for t, t2 in FLASH_SHAPES
                 if t == t2 for h, hkv in FLASH_HEADS for d in (64, 128, 256)]
        cases += [(tq, h, hkv, d, window, causal) for tq, tk, h, hkv, d,
                  causal, window, q_offset, _ in FLASH_EXTRA
                  if tq == tk and q_offset == 0]
        for t, h, hkv, d, window, causal in cases:
            q, k, v = _flash_inputs(gen, 1, t, t, h, hkv, d, dtype, dev)
            with_lse = kflash._forward(q, k, v, causal=causal, window=window,
                                       q_offset=0, block_k=1024,
                                       with_lse=True)
            check(torch.equal(with_lse[0], kflash.flash_attention_cuda(
                q, k, v, causal=causal, window=window)) and bool(
                    torch.isfinite(with_lse[1]).all()),
                  f"flash forward {dtype} {(t, h, hkv, d, window, causal)}: "
                  f"output with its log-sum-exp differs from the output "
                  f"without")
            swept += 1
    log(f"[train] flash forward with the log-sum-exp written: {swept} "
        f"self-attention shapes, output bit-equal to the forward without")
    return {"rows": rows, "lse_bitwise_cases": swept}


def _train_model(dtype, n_layers=None):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_config(TRAIN["arch"]), dtype=dtype,
                              param_dtype=dtype)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg, LM(cfg)


def _train_run(model, params, batches, impl) -> dict:
    """12 AdamW steps from ``params`` on ``batches``, launch/train.py's
    schedule, through the kernels (impl None) or the plain versions."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import WARMUP_STEPS, train_step
    from repro_torch.optim import adamw_init, linear_warmup_cosine

    opt_state = adamw_init(params)
    ces, gnorms, ms = [], [], []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with ops.use_impl(impl):
        for step, batch in enumerate(batches):
            lr = linear_warmup_cosine(step, base_lr=TRAIN["lr"],
                                      warmup_steps=WARMUP_STEPS,
                                      total_steps=len(batches))
            t0 = time.perf_counter()
            params, opt_state, _, ce, gnorm = train_step(
                model, params, opt_state, batch, lr)
            ces.append(float(ce))  # waits for the step
            ms.append((time.perf_counter() - t0) * 1e3)
            gnorms.append(float(gnorm))
    return {"params": params, "ce": ces, "gnorm": gnorms, "ms": ms,
            "launches": ops.launch_counts()}


def _step0_grads(model, params, batch) -> dict:
    """Step 0's gradients through the kernels and the plain versions:
    each leaf's relative norm error, the worst, and both losses."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.tree import leaves

    loss_k, _, grads_k = loss_and_grads(model, params, batch)
    with ops.use_impl("ref"):
        loss_r, _, grads_r = loss_and_grads(model, params, batch)
    errs = [float(torch.linalg.vector_norm((a.float() - b.float()))
                  / torch.linalg.vector_norm(b.float()).clamp_min(1e-30))
            for a, b in zip(leaves(grads_k), leaves(grads_r))]
    return {"loss": float(loss_k), "loss_plain": float(loss_r),
            "grad_rel_norm_err": max(errs), "leaves": len(errs)}


def _train_phase(dtype, batches, n_layers=None) -> "tuple[dict, tuple]":
    """(b) and (c): one model, the kernels' run and the plain versions'
    from one init on ``batches``; returns the record and (model, trained
    params)."""
    from repro_torch.core.base import root_key
    from repro_torch.launch.train import train_step
    from repro_torch.optim import adamw_init

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 in float32
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg, model = _train_model(dtype, n_layers)
    name = str(dtype).split(".")[-1]
    tol = TRAIN_TOL[dtype]
    L, steps = cfg.n_layers, len(batches)
    tokens = TRAIN["batch"] * TRAIN["seq"]
    params0 = model.init(root_key(TRAIN["seed"], device=dev))
    grads = _step0_grads(model, params0, batches[0])
    check(grads["grad_rel_norm_err"] <= tol["grad"],
          f"train {name}: step 0's gradients through the kernels differ from "
          f"the plain versions' by {grads['grad_rel_norm_err']:.3e} > "
          f"{tol['grad']} (relative norm, worst leaf)")
    torch.cuda.reset_peak_memory_stats()
    kern = _train_run(model, params0, batches, None)
    peak = torch.cuda.max_memory_allocated()
    plain = _train_run(model, params0, batches, "ref")
    # the backward's route at the model's head dim, and the sm90 route's
    # runs of heads (a sum pass when more than one)
    from repro_torch.kernels import flash_attention as kflash

    hd = cfg.head_dim
    route = kflash.flash_bwd_route(dtype, hd)
    splits = _bwd_splits(route, TRAIN["batch"], TRAIN["seq"], cfg.n_heads,
                         cfg.n_kv_heads, hd)
    want = {**NO_LM, "fwht": 0, "srht_apply": 0, "srht_apply_t": 0,
            **NO_ROWS, **NO_CODEC, "flash_attention": 2 * L * steps,
            f"flash_attention_{FLASH_ROUTE[dtype]}": 2 * L * steps,
            "flash_attention_bwd": L * steps,
            f"flash_attention_bwd_{route}": L * steps,
            f"flash_attention_bwd_{route}_sum": L * steps * (splits > 1),
            **{f"flash_attention_bwd_{k}": L * steps
               for k in BWD_ROUTE_KERNELS[route]}}
    check(kern["launches"] == want,
          f"train {name}: launches {kern['launches']} != {want} (with remat "
          f"the forward kernel runs twice a layer a step, the {route} "
          f"backward once)")
    check(all(n == 0 for n in plain["launches"].values()),
          f"train {name}: the plain run launched {plain['launches']}")
    ce_k, ce_p = np.array(kern["ce"]), np.array(plain["ce"])
    ce_err = float(np.max(np.abs(ce_k - ce_p) / np.abs(ce_p)))
    check(np.isfinite(ce_k).all() and np.isfinite(ce_p).all(),
          f"train {name}: a CE is not finite: {kern['ce']} / {plain['ce']}")
    check(ce_err <= tol["ce"],
          f"train {name}: the CE trajectory through the kernels {kern['ce']} "
          f"differs from the plain versions' {plain['ce']} by {ce_err:.3e} "
          f"> {tol['ce']} (relative)")
    check(ce_k[-1] < ce_k[0], f"train {name}: the last CE {ce_k[-1]:.4f} is "
          f"not below the first {ce_k[0]:.4f}")
    params = kern.pop("params")
    del plain["params"]
    torch.cuda.empty_cache()

    # one more step of each, through the profiler (from the trained params)
    state = {"params": params, "opt": adamw_init(params)}

    def step():
        state["params"], state["opt"], *_ = train_step(
            model, state["params"], state["opt"], batches[0], 1e-5)
    profile = _profile_call(step)
    del state
    torch.cuda.empty_cache()
    steady = kern["ms"][1:]
    ms = float(np.median(steady))
    out = {"arch": cfg.arch_id, "dtype": name, "n_layers": L,
           "d_model": cfg.d_model, "batch": TRAIN["batch"],
           "seq": TRAIN["seq"], "steps": steps, "step0": grads, "ce": kern["ce"], "ce_plain": plain["ce"],
           "gnorm": kern["gnorm"], "gnorm_plain": plain["gnorm"],
           "ce_rel_err": ce_err, "tolerance": tol,
           "ms_per_step": kern["ms"], "ms_per_step_plain": plain["ms"],
           "ms_median": ms, "tokens_per_s": tokens / ms * 1e3,
           "plain_ms_median": float(np.median(plain["ms"][1:])),
           "peak_memory_bytes": peak, "launches": kern["launches"],
           "profile": profile, "flash_bwd_share_of_device":
               profile["flash_bwd_us"] / profile["device_busy_us"],
           "flash_fwd_share_of_device": profile["flash_share_of_device"]}
    log(f"[train] {cfg.arch_id} {name} {L} layers d {cfg.d_model}, batch "
        f"{TRAIN['batch']} x {TRAIN['seq']}: CE through the kernels "
        + " ".join(f"{c:.4f}" for c in kern["ce"]))
    log(f"[train]   plain versions' CE " + " ".join(
        f"{c:.4f}" for c in plain["ce"]) + f"; worst relative difference "
        f"{ce_err:.2e} (tol {tol['ce']}); step 0 loss {grads['loss']:.5f} vs "
        f"{grads['loss_plain']:.5f}, gradients' worst relative norm error "
        f"{grads['grad_rel_norm_err']:.2e} over {grads['leaves']} leaves "
        f"(tol {tol['grad']})")
    log(f"[train]   {ms:.2f} ms a step (median of steps 1-{steps - 1}; first "
        f"{kern['ms'][0]:.1f}), {out['tokens_per_s']:,.0f} tokens/s, plain "
        f"versions {out['plain_ms_median']:.1f} ms; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {kern['launches']}")
    log(f"[train]   a profiled step: device busy "
        f"{profile['busy_share']:.1%} of {profile['wall_us'] / 1e3:.2f} ms; "
        f"flash backward {out['flash_bwd_share_of_device']:.1%} and forward "
        f"{out['flash_fwd_share_of_device']:.1%} of device time")
    for r in profile["top"][:8]:
        log(f"[train]     {r['us'] / 1e3:9.3f} ms x{r['launches']:<4d} "
            f"{r['kernel']}")
    log(f"[train]   host self time {profile['host_self_us'] / 1e3:.2f} ms "
        f"under the profiler; its top ops:")
    for r in profile["host_top"][:6]:
        log(f"[train]     {r['us'] / 1e3:9.3f} ms x{r['calls']:<5d} {r['op']}")
    return out, (model, params)


def phase_flens_head(model, params) -> dict:
    """(d): FLeNS, FedAvg and FedNewton on the head of the trained bf16
    backbone, examples/federated_llm.py's setting at D = 2048."""
    from repro_torch.core import make_optimizer, newton_solve, run_rounds
    from repro_torch.kernels import ops
    from repro_torch.optim import extract_features, head_problem

    dev = _card()
    cfg = model.cfg
    m, rounds = HEAD["m"], HEAD["rounds"]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(m * HEAD["per_client"],
                                            HEAD["seq"]))
    # the example's label, a sequence holding two tokens of the lowest
    # 1/32 of the vocab (8 of its 256), so positives keep its share
    labels = np.where((toks < cfg.vocab // 32).sum(axis=1) >= 2, 1.0, -1.0)
    feats = extract_features(model, params,
                             torch.tensor(toks, dtype=torch.int32, device=dev))
    check(feats.shape == (len(labels), cfg.d_model)
          and bool(torch.isfinite(feats).all()), "head: features not finite")
    prob = head_problem(feats, torch.tensor(labels, device=dev), m,
                        lam=HEAD["lam"])
    w0 = torch.zeros(prob.dim, dtype=torch.float64, device=dev)
    w_star = newton_solve(prob, w0, iters=40)
    out = {"features": list(feats.shape), "positives": float(
        (labels > 0).mean()), "rounds": rounds}
    for name, kw in (("flens", dict(k=HEAD["k"])),
                     ("fedavg", dict(lr=1.0, local_steps=5)),
                     ("fednewton", {})):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        hist = run_rounds(make_optimizer(name, **kw), prob, w0, w_star,
                          rounds=rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        # FedAvg keeps the example's step (lr 1.0), made for its d = 128
        # features: on these it need not converge, and only its losses are
        # checked finite
        check(np.isfinite(hist.loss).all() and (
            name == "fedavg" or hist.gap[-1] < hist.gap[0]),
              f"head {name}: gap {hist.gap.tolist()}")
        want = {**NO_LM, **NO_CODEC, **NO_ROWS, "fwht": 0, "srht_apply": 0,
                "srht_apply_t": 0}
        if name == "flens":
            want.update(srht_apply=3 * rounds, srht_apply_t=2 * rounds)
            with ops.use_impl("ref"):
                plain = run_rounds(make_optimizer(name, **kw), prob, w0,
                                   w_star, rounds=rounds)
            check((hist.loss == plain.loss).all()
                  and (hist.gap == plain.gap).all(),
                  f"head flens: through the kernels {hist.loss.tolist()} != "
                  f"through the plain versions {plain.loss.tolist()}")
        check(counts == want, f"head {name}: launches {counts} != {want}")
        out[name] = {"gap": hist.gap.tolist(), "loss": hist.loss.tolist(),
                     "uplink_floats": hist.uplink_floats,
                     "ms_per_round": wall / rounds * 1e3,
                     "launches": {op: n for op, n in counts.items() if n}}
        log(f"[train] head {name:>9}: D {prob.dim}, uplink/round "
            f"{hist.uplink_floats}, gap " + " ".join(
                f"{g:.1e}" for g in hist.gap[::2]) + f"; launches "
            f"{out[name]['launches']}"
            + ("; trajectory bit-equal to the plain versions'"
               if name == "flens" else ""))
    acc = float(((feats.double() @ w_star > 0)
                 == torch.tensor(labels > 0, device=dev)).double().mean())
    out["head_accuracy"] = acc
    log(f"[train] head accuracy at w*: {acc:.3f} (positives "
        f"{out['positives']:.2f})")
    return out


def phase_train() -> dict:
    """13: (a) the backward kernel, (b) TinyLlama-1.1B bf16 training, (c)
    its float32 twin at 4 layers, (d) the FLeNS head on (b)'s backbone."""
    from repro_torch.configs import get_config
    from repro_torch.data import FastLMStream

    t0 = time.perf_counter()
    record = {"flash_bwd": phase_flash_bwd()}
    t1 = time.perf_counter()
    batches = list(FastLMStream(get_config(TRAIN["arch"]).vocab,
                                TRAIN["seq"], TRAIN["batch"],
                                seed=TRAIN["seed"], device=_card()).batches(
                                    TRAIN["steps"]))
    record["stream_s"] = time.perf_counter() - t1
    log(f"[train] {TRAIN['steps']} FastLMStream batches of "
        f"{TRAIN['batch']} x {TRAIN['seq']} tokens in "
        f"{record['stream_s']:.2f} s (host)")
    record["bf16"], (model, params) = _train_phase(torch.bfloat16, batches)
    record["head"] = phase_flens_head(model, params)
    del model, params
    torch.cuda.empty_cache()
    record["f32"], _ = _train_phase(torch.float32, batches,
                                    TRAIN["f32_layers"])
    record["seconds"] = time.perf_counter() - t0
    log(f"[train] phase 13 took {record['seconds']:.1f} s")
    return record


# ---------------------------------------------------------------------------
# 14. train over a mesh
# ---------------------------------------------------------------------------

MESH_TRAIN_DIR = ROOT / "chiprun_out" / "mesh_train"
# 14: LM training over a mesh in the reference's train_4k layout (the
# parameters, gradients and AdamW moments each leaf's block under
# rules.param_spec, the batch's rows over data), 4 gloo ranks on the one
# card, one part a family: (a) TinyLlama-1.1B whole in bf16 with remat on
# (2 data, 2 model), 2 x 2048 tokens (one row a data rank: q (1, 2048, 16,
# 64) and K, V (1, 2048, 2, 64) a rank), TRAIN's schedule, 3 AdamW steps;
# (b) its float32 twin at 4 layers (tf32x3 forward and backward); (c)
# arctic-480b at full width (d_model 7168, expert d_ff 4864, top-2, its
# dense residual MLP), 1 layer, 8 of its 128 experts (16 do not fit: four
# ranks' float32 parameters, gradients and moments and the decode
# branch's gathered experts and their cotangents), float32, one AdamW step
# on the decode branch ((2, 2) at 2 x 2048) and on the expert branch
# (model 4); (d) mamba2-780m at full width, 4 of its 48 layers, bf16, (2,
# 2): its 48 SSD heads 24 a rank, no flash; (e) recurrentgemma-2b at full
# width, one (rec, rec, attn) super-block, bf16, (2, 2): the RG-LRU width
# 1280 a rank, the local attention (window 2048, 5 of 10 q heads over its
# one KV head) a rank; (f) gemma3-4b@rightsized at full width, one
# super-block of 5 local layers (window 1024) and a global one, bf16,
# model 4 (2 q heads over one KV head a rank); (g) whisper-tiny whole in
# float32 on (2, 2): its 4 encoder layers over 1500 frames (non-causal,
# run once a step) and 4 decoder layers over 448 tokens, its published
# text context (tf32x3 forward and backward); (h) llama-3.2-vision-90b at
# full width, one super-block (4 self layers and a gated cross layer over
# 1601 vision tokens; the gates drawn as 11d's), bf16, model 4: 6.39 B
# parameters, 12.8 GB, and its AdamW moments (51.1 GB in float32) do not
# fit beside the no-mesh run's parameters and gradients on the one card,
# so this part takes step 0's loss and gradients alone (steps 0). Each
# part's no-mesh run from the same weights and batches comes first, in
# this process; the ranks draw the same weights from the seed one after
# another, and hold step 0's gradient blocks and every step's CE to the
# no-mesh run's
MT_CUTS = {"arctic": dict(n_layers=1, n_experts=8)}
MESH_TRAIN = dict(
    ranks=4, timeout_s=900, seed=0, batch=2, seq=2048,
    parts={"tiny": dict(arch="tinyllama-1.1b", cuts={}, dtype="bfloat16",
                        mesh=((2, 2), ("data", "model")), steps=3,
                        yardstick=True),
           "twin": dict(arch="tinyllama-1.1b", cuts=dict(n_layers=4),
                        dtype="float32", mesh=((2, 2), ("data", "model")),
                        steps=3),
           "arctic_decode": dict(arch="arctic-480b", cuts=MT_CUTS["arctic"],
                                 dtype="float32",
                                 mesh=((2, 2), ("data", "model")), steps=1,
                                 weights="arctic"),
           "arctic_expert": dict(arch="arctic-480b", cuts=MT_CUTS["arctic"],
                                 dtype="float32", mesh=((4,), ("model",)),
                                 steps=1, weights="arctic"),
           "mamba2": dict(arch="mamba2-780m", cuts=dict(n_layers=4),
                          dtype="bfloat16", mesh=((2, 2), ("data", "model")),
                          steps=2, yardstick=True),
           "griffin": dict(arch="recurrentgemma-2b", cuts=dict(n_layers=3),
                           dtype="bfloat16",
                           mesh=((2, 2), ("data", "model")), steps=2),
           "gemma3": dict(arch="gemma3-4b@rightsized", cuts=dict(n_layers=6),
                          dtype="bfloat16", mesh=((4,), ("model",)), steps=2),
           "whisper": dict(arch="whisper-tiny", cuts={}, dtype="float32",
                           mesh=((2, 2), ("data", "model")), steps=2,
                           seq=448),
           "vlm": dict(arch="llama-3.2-vision-90b", cuts=dict(n_layers=5),
                       dtype="bfloat16", mesh=((4,), ("model",)), steps=0)},
    # step 0's gradient blocks against the no-mesh run's: bf16 each leaf's
    # relative norm error (phase 13's); float32 each leaf's largest |error|
    # over its largest |value|, 1e-5 (arctic: 5i's 1e-4, its experts'
    # products summed over data in another order)
    grad_tol={**dict.fromkeys(("tiny", "mamba2", "griffin", "gemma3", "vlm"),
                              ("rel_norm",
                               TRAIN_TOL[torch.bfloat16]["grad"])),
              "twin": ("max_abs", 1e-5), "whisper": ("max_abs", 1e-5),
              "arctic_decode": ("max_abs", 1e-4),
              "arctic_expert": ("max_abs", 1e-4)},
    ce_tol={"bfloat16": TRAIN_TOL[torch.bfloat16]["ce"], "float32": 1e-5})


def _mt_model(part: dict):
    """(cfg, model) of a phase 14 part: its arch in its dtype, cut."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    dtype = MESH_DTYPES[part["dtype"]]
    cfg = dataclasses.replace(get_config(part["arch"]), dtype=dtype,
                              param_dtype=dtype, **part["cuts"])
    return cfg, LM(cfg)


def _mt_init(part: dict):
    """(cfg, model, its weights drawn from the seed on the card): the vlm's
    zero-initialised gates drawn as 11d's (``_cross_model``), so that the
    vision memory reaches the loss. The parent and each rank draw the
    same weights."""
    from repro_torch.core.base import root_key

    cfg, model = _mt_model(part)
    params = model.init(root_key(MESH_TRAIN["seed"], device=_card()))
    if cfg.family == "vlm":
        gen = root_key(CROSS["seed"], 11, device=_card())
        for name in ("gate", "gate_mlp"):
            params["group0"]["cross"][name].uniform_(*CROSS["gates"],
                                                     generator=gen)
    return cfg, model, params


def _mt_batches(cfg, part: dict) -> list:
    """A part's batches on the card, one a step (one for a part of 0
    steps): FastLMStream's tokens of the part's length, with the vlm's
    vision tokens (B, 1601, 1280) or whisper's frames (B, 1500, 384),
    standard normal float32, from the seed."""
    from repro_torch.data import FastLMStream

    dev = _card()
    b = MESH_TRAIN["batch"]
    batches = list(FastLMStream(cfg.vocab, part.get("seq", MESH_TRAIN["seq"]),
                                b, seed=MESH_TRAIN["seed"],
                                device=dev).batches(max(part["steps"], 1)))
    gen = torch.Generator(device=dev).manual_seed(MESH_TRAIN["seed"])
    memory = {"vlm": ("vision", cfg.vision_tokens, cfg.vision_dim),
              "audio": ("audio_frames", cfg.audio_frames, cfg.d_model)}
    if cfg.family in memory:
        key, s, width = memory[cfg.family]
        for batch in batches:
            batch[key] = torch.randn((b, s, width), generator=gen, device=dev)
    return batches


def _mt_lr(step: int, steps: int):
    from repro_torch.launch.train import WARMUP_STEPS
    from repro_torch.optim import linear_warmup_cosine

    return linear_warmup_cosine(step, base_lr=TRAIN["lr"],
                                warmup_steps=WARMUP_STEPS, total_steps=steps)


def _mt_steps(model, params, batches, steps: int) -> dict:
    """step 0's (loss, ce, aux, gradients), then ``steps`` AdamW steps
    from ``params`` on ``batches`` (under the active mesh, if any): CE and
    gnorm a step, ms a step, the launches, the collectives' bytes and host
    seconds a step by kind, and the peak memory of the steps; with 0
    steps these of step 0's loss and gradients (no AdamW state), its CE
    the one CE."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import loss_and_grads, train_step
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import tensor_parallel as tp

    def reset():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        tp.reset_moved_bytes()

    reset()
    t0 = time.perf_counter()
    loss, met, grads = loss_and_grads(model, params, batches[0])
    step0 = {"loss": float(loss), "ce": float(met["ce"]),
             "aux": float(met["aux"])}
    if not steps:
        return {"step0": step0, "grads": grads, "ce": [step0["ce"]],
                "gnorm": [], "ms": [(time.perf_counter() - t0) * 1e3],
                "launches": ops.launch_counts(),
                "moved_bytes_per_step": tp.moved_bytes(),
                "collective_ms_per_step": {
                    k: v * 1e3 for k, v in tp.collective_seconds().items()},
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "state_bytes": 0, "params": params}
    opt = adamw_init(params)
    state_bytes = _tree_bytes({"m": opt["m"], "v": opt["v"]})
    reset()
    ces, gnorms, ms = [], [], []
    for step in range(steps):
        t0 = time.perf_counter()
        params, opt, _, ce, gnorm = train_step(
            model, params, opt, batches[step], _mt_lr(step, steps))
        ces.append(float(ce))  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(gnorm))
    return {"step0": step0, "grads": grads, "ce": ces, "gnorm": gnorms,
            "ms": ms, "launches": ops.launch_counts(),
            "moved_bytes_per_step": {k: v / steps for k, v in
                                     tp.moved_bytes().items()},
            "collective_ms_per_step": {k: v * 1e3 / steps for k, v in
                                       tp.collective_seconds().items()},
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "state_bytes": state_bytes, "params": params}


def _mt_reference(name: str, part: dict, tmp: pathlib.Path,
                  done: dict) -> dict:
    """A part's run without a mesh in this process (once for the parts
    that share ``weights``: the same model, weights, batches and steps):
    its weights drawn from the seed on the card (``_mt_init``; the ranks
    draw them too), its batches, step 0's gradients and CEs saved to
    ``tmp`` for the ranks under the part's ``weights`` name; returns the
    run's stats. Frees the card."""
    from repro_torch.launch.input_specs import param_shapes
    from repro_torch.tree import tree_map

    key = part.get("weights", name)
    if key in done:
        return done[key]
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 in float32
    torch.backends.cudnn.allow_tf32 = False
    cfg, model, params = _mt_init(part)
    batches = _mt_batches(cfg, part)
    torch.save([{k: v.cpu() for k, v in b.items()} for b in batches],
               tmp / f"{key}_batches.pt")
    run = _mt_steps(model, params, batches, part["steps"])
    torch.save(tree_map(lambda a: a.cpu(), run.pop("grads")),
               tmp / f"{key}_grads.pt")
    del run["params"]
    torch.cuda.empty_cache()
    if part.get("yardstick"):
        # step 0's gradient of the same weights in float32
        from repro_torch.launch.train import loss_and_grads
        from repro_torch.models.lm import LM

        f32 = dataclasses.replace(cfg, dtype=torch.float32,
                                  param_dtype=torch.float32)
        params = tree_map(lambda a: a.float(), params)
        grads = loss_and_grads(LM(f32), params, batches[0])[2]
        torch.save(tree_map(lambda a: a.cpu(), grads),
                   tmp / f"{key}_grads_f32.pt")
        del grads
    del params, batches, model
    torch.cuda.empty_cache()
    torch.save({"ce": run["ce"], "step0": run["step0"]},
               tmp / f"{key}_plain.pt")
    run["param_bytes"] = _tree_bytes(param_shapes(cfg))
    done[key] = run
    log(f"[mesh train] ({key}) no mesh: {cfg.arch_id} {cfg.n_layers} layers "
        f"{part['dtype']}, CE " + " ".join(f"{c:.5f}" for c in run["ce"])
        + f", " + " / ".join(f"{x:.1f}" for x in run["ms"]) + " ms a step, "
        f"peak {run['peak_bytes'] / 2**30:.2f} GiB")
    return run


def _mt_flash_parity(calls: list, dtype) -> list:
    """The flash forward and backward at each of a rank's distinct
    training calls (``_flash_calls``' record: its rows, q heads and the
    KV heads they read, the call's causality and window) against their
    plain versions on random inputs in the part's dtype; not counted in
    the runs."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops, ref

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    rows, seen = [], []
    for q_shape, k_shape, _, kw in calls:
        if (q_shape, k_shape, kw) in seen:
            continue
        seen.append((q_shape, k_shape, kw))
        (b, t, h, d), hkv = q_shape, k_shape[2]
        causal, window = kw.get("causal", True), kw.get("window")
        q, k, v = _flash_inputs(gen, b, t, t, h, hkv, d, dtype, dev)
        do = torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype)
        fwd = _max_err(ops.flash_attention(q, k, v, **kw).float(),
                       ops.flash_attention(q, k, v, impl="ref", **kw).float())
        out, lse = kflash._forward(q, k, v, causal=causal, window=window,
                                   q_offset=0, block_k=1024, with_lse=True)
        got = kflash.flash_attention_bwd_cuda(q, k, v, out, do, lse,
                                              causal=causal, window=window)
        want = ref.mha_blocked_grad(q, k, v, do, causal=causal,
                                    window=window)
        bwd = {g: _rel_err(x, w)
               for g, x, w in zip(("dq", "dk", "dv"), got, want)}
        route, bwd_route = FLASH_ROUTE[dtype], kflash.flash_bwd_route(dtype, d)
        check(fwd <= FLASH_TOL[dtype],
              f"mesh train: the {route} forward at q {q_shape} k {k_shape} "
              f"{kw} differs from its plain version by {fwd:.3e}")
        check(max(bwd.values()) <= FLASH_BWD_TOL[dtype],
              f"mesh train: the {bwd_route} backward at q {q_shape} k "
              f"{k_shape} {kw} differs from its plain version by {bwd}")
        rows.append({"q": q_shape, "k": k_shape, **kw, "route": route,
                     "bwd_route": bwd_route,
                     "splits": _bwd_splits(bwd_route, b, t, h, hkv, d),
                     "forward_max_abs_err": fwd, "backward_rel_err": bwd})
        del q, k, v, do, out, lse, got, want
    return rows


def _mt_flash_want(cfg, part: dict) -> dict:
    """The flash launches a step a rank: each self-attention layer's
    forward twice with remat (once without) and its backward once on the
    rank's rows and heads, whisper's encoder layers once each (the
    encoder is not recomputed), on the part's routes, with the backward's
    sum pass where the rank's call cuts its q heads into runs; none in
    mamba2."""
    from repro_torch.kernels.flash_attention import flash_bwd_route
    from repro_torch.models.lm import build_groups

    sizes = dict(zip(part["mesh"][1], part["mesh"][0]))
    per = {"dense": 1, "moe": 1, "griffin": 1, "dec": 1,
           "dense_sb": (cfg.local_per_global or 0) + 1,
           "vlm": cfg.cross_attn_every}
    n_self = sum(g.n * per.get(g.kind, 0) for g in build_groups(cfg))
    h, hkv = _rank_heads(cfg, sizes.get("model", 1))
    b = MESH_TRAIN["batch"] // sizes.get("data", 1)
    # (tokens, forward calls, backward calls) a step
    calls = [(part.get("seq", MESH_TRAIN["seq"]),
              n_self * (2 if cfg.remat else 1), n_self),
             (cfg.audio_frames, cfg.encoder_layers, cfg.encoder_layers)]
    route = FLASH_ROUTE[cfg.dtype]
    bwd = flash_bwd_route(cfg.dtype, cfg.head_dim)
    fwd = sum(c[1] for c in calls)
    back = sum(c[2] for c in calls)
    summed = sum(n for t, _, n in calls
                 if n and _bwd_splits(bwd, b, t, h, hkv, cfg.head_dim) > 1)
    return {**NO_LM, "flash_attention": fwd, f"flash_attention_{route}": fwd,
            "flash_attention_bwd": back, f"flash_attention_bwd_{bwd}": back,
            f"flash_attention_bwd_{bwd}_sum": summed,
            **{f"flash_attention_bwd_{k}": back
               for k in BWD_ROUTE_KERNELS[bwd]}}


def _mt_err(g: torch.Tensor, w: torch.Tensor, kind: str) -> float:
    """The relative norm error of ``g`` against ``w``, or the largest
    |error| over the largest |w|."""
    g, w = g.float(), w.to(g.device).float()
    if kind == "rel_norm":
        return float(torch.linalg.vector_norm(g - w)
                     / torch.linalg.vector_norm(w).clamp_min(1e-30))
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def _mt_grad_errs(got, want, kind: str, yard=None) -> dict:
    """Each leaf's error (``_mt_err``) of the rank's gradient block against
    its block of the no-mesh gradient ``want``: the worst, and the three
    worst leaves by path; with a float32 yardstick ``yard`` (the same
    weights' gradient in float32) each of those leaves' relative norm
    errors of the mesh run and of the no-mesh run against it."""
    pairs = [(path, _mt_err(g, w, kind)) for (path, g), (_, w) in
             zip(_tree_paths(got), _tree_paths(want))]
    worst = sorted(pairs, key=lambda pe: -pe[1])[:3]
    rows = []
    for path, err in worst:
        row = {"leaf": path, "err": err}
        if yard is not None:
            at = {p: (g, w, y) for (p, g), (_, w), (_, y) in zip(
                _tree_paths(got), _tree_paths(want), _tree_paths(yard))}
            g, w, y = at[path]
            row["mesh_vs_f32"] = _mt_err(g, y, "rel_norm")
            row["no_mesh_vs_f32"] = _mt_err(w, y, "rel_norm")
        rows.append(row)
    return {"max": worst[0][1], "worst": rows, "leaves": len(pairs),
            "finite": all(bool(torch.isfinite(g).all())
                          for _, g in _tree_paths(got))}


def mesh_train_child(job_path: str, rank: int) -> int:
    """One rank of phase 14: each part's weights (drawn from the seed as
    the parent drew them, one rank after another) cut to the rank's
    training shard, step 0's gradient blocks against the no-mesh run's
    (from ``tmp``), then the part's AdamW steps under its mesh, gloo over
    CUDA tensors, its flash calls recorded (rank 0 holds the kernels
    against their plain versions at each); writes its stats. Loads the
    flash kernels the parent built."""
    from repro_torch.kernels import _build
    from repro_torch.launch.input_specs import param_shapes
    from repro_torch.launch.mesh import make_mesh, process_group
    from repro_torch.sharding import rules
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.tree import leaves

    job = json.loads(pathlib.Path(job_path).read_text())
    for stem in ("flash_attention_sm90", "flash_attention",
                 "flash_attention_bwd_sm90", "flash_attention_bwd"):
        check(_build._target(_build.CSRC / f"{stem}.cu").exists(),
              f"mesh train child: {stem}.cu is not built (the parent "
              f"builds it)")
    dev = _card()
    torch.cuda.set_device(dev)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // job["ranks"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = pathlib.Path(job["tmp"])
    out, meshes = {}, {}
    progress = open(pathlib.Path(job["out"]) / f"rank{rank}.log", "w")
    t_child = time.perf_counter()

    def note(what):
        progress.write(f"{time.perf_counter() - t_child:8.1f} s  {what}\n")
        progress.flush()
    with process_group(rank, job["ranks"], job["store"], backend="gloo",
                       timeout_s=job["timeout_s"]):
        for name, part in MESH_TRAIN["parts"].items():
            shape, axes = part["mesh"]
            if (shape, axes) not in meshes:
                meshes[shape, axes] = make_mesh(shape, axes, "cuda")
            mesh = meshes[shape, axes]
            cfg, model = _mt_model(part)
            key = part.get("weights", name)
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            for r in range(job["ranks"]):
                if r == rank:
                    local = rules.training_shard(mesh, _mt_init(part)[2])
                    torch.cuda.empty_cache()
                torch.distributed.barrier()
            want = rules.training_shard(mesh, torch.load(
                tmp / f"{key}_grads.pt", mmap=True))
            batches = [{k: v.to(dev) for k, v in b.items()}
                       for b in torch.load(tmp / f"{key}_batches.pt")]
            layout = rules.shard_tree(mesh, param_shapes(cfg),
                                      rules.param_spec)
            rec = {"param_bytes": _tree_bytes(local),
                   "layout_param_bytes": _tree_bytes(layout),
                   # m and v in float32, none without AdamW steps
                   "layout_state_bytes": 2 * 4 * sum(
                       a.numel() for a in leaves(layout))
                   * (part["steps"] > 0),
                   "load_s": time.perf_counter() - t0}
            note(f"{name}: loaded in {rec['load_s']:.1f} s")
            torch.distributed.barrier()
            with use_mesh(mesh), _flash_calls() as calls:
                run = _mt_steps(model, local, batches, part["steps"])
            note(f"{name}: steps " + " / ".join(f"{x:.0f}" for x in run["ms"])
                 + " ms")
            kind, _ = MESH_TRAIN["grad_tol"][name]
            yard = (rules.training_shard(mesh, torch.load(
                tmp / f"{key}_grads_f32.pt", mmap=True))
                if part.get("yardstick") else None)
            rec["grad_errs"] = _mt_grad_errs(run.pop("grads"), want, kind,
                                             yard)
            del want, yard, run["params"], local
            rec.update(run)
            lay = tp.layout(mesh)
            rec["coord"] = lay.coord
            plain = torch.load(tmp / f"{key}_plain.pt")
            rec["plain_ce"] = plain["ce"]
            rec["plain_step0"] = plain["step0"]
            if rank == 0:
                rec["flash_parity"] = _mt_flash_parity(calls, cfg.dtype)
            out[name] = rec
            torch.cuda.empty_cache()
            torch.distributed.barrier()
    (pathlib.Path(job["out"]) / f"rank{rank}.json").write_text(
        json.dumps(out, default=str))
    return 0


def phase_mesh_train(card: str) -> dict:
    """14: every group kind trained over a mesh (``LM.loss``,
    ``launch/train.py``'s ``train_step`` and ``adamw_update`` under
    ``sharding.ctx.use_mesh``), ``MESH_TRAIN``'s parts on 4 gloo ranks of
    the one card against the same weights and batches without a mesh in
    this process."""
    import tempfile

    from repro_torch.launch.mesh import spawn

    out_dir = MESH_TRAIN_DIR
    t_phase = time.perf_counter()
    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="mesh_train_"))
    try:
        done: dict = {}
        plain = {name: _mt_reference(name, part, tmp, done)
                 for name, part in MESH_TRAIN["parts"].items()}
        log(f"[mesh train] the no-mesh runs' gradients and batches: "
            f"{sum(f.stat().st_size for f in tmp.iterdir()) / 1e9:.1f} GB "
            f"in {tmp}, {shutil.disk_usage(tmp).free / 1e9:.1f} GB free "
            f"there")
        ranks = MESH_TRAIN["ranks"]
        job = {"ranks": ranks, "store": str(out_dir / "store"),
               "out": str(out_dir), "tmp": str(tmp),
               "timeout_s": MESH_TRAIN["timeout_s"]}
        (out_dir / "job.json").write_text(json.dumps(job))
        t0 = time.perf_counter()
        spawn(lambda r: [sys.executable, str(ROOT / "chip_smoke.py"),
                         "--mesh-train-child", str(out_dir / "job.json"),
                         str(r)], ranks, timeout_s=MESH_TRAIN["timeout_s"])
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = [json.loads((out_dir / f"rank{r}.json").read_text())
           for r in range(ranks)]
    record = {"card": card, "ranks": ranks}
    for name, part in MESH_TRAIN["parts"].items():
        record[name] = _mt_check_part(name, part, plain[name],
                                      [g[name] for g in got], card)
    record["spawn_s"] = spawn_s
    record["seconds"] = time.perf_counter() - t_phase
    log(f"[mesh train] phase 14 on {card} took {record['seconds']:.1f} s "
        f"(the ranks {spawn_s:.1f} s from spawn to join)")
    return record


def _mt_check_part(name: str, part: dict, plain: dict, ranks: list,
                   card: str) -> dict:
    """Check one part's ranks: parameter and moment bytes as the layout's,
    every step's CE equal across ranks and within tolerance of the no-mesh
    run's, step 0's gradient blocks within tolerance, the flash launches a
    step a rank on the part's routes (``_mt_flash_want``), the flash
    kernels held against their plain versions at each of the rank's
    distinct calls; log times, bytes and memory."""
    cfg, _ = _mt_model(part)
    layers = cfg.n_layers
    sizes = dict(zip(part["mesh"][1], part["mesh"][0]))
    label = f"mesh train ({name})"
    steps = part["steps"]
    counted = max(steps, 1)  # the AdamW steps, or step 0's loss_and_grads
    for r, rec in enumerate(ranks):
        check(rec["param_bytes"] == rec["layout_param_bytes"],
              f"{label}: rank {r} holds {rec['param_bytes']} parameter bytes, "
              f"its training shard {rec['layout_param_bytes']}")
        check(rec["state_bytes"] == rec["layout_state_bytes"],
              f"{label}: rank {r} holds {rec['state_bytes']} moment bytes, "
              f"the layout's {rec['layout_state_bytes']}")
    ces = [rec["ce"] for rec in ranks]
    check(all(c == ces[0] for c in ces),
          f"{label}: the ranks' CEs differ: {ces}")
    check(all(math.isfinite(c) for c in ces[0]),
          f"{label}: a CE is not finite: {ces[0]}")
    ce_tol = MESH_TRAIN["ce_tol"][part["dtype"]]
    ce_err = max(abs(a - b) / abs(b) for a, b in zip(ces[0], plain["ce"]))
    check(ce_err <= ce_tol,
          f"{label}: CE {ces[0]} differs from the no-mesh run's "
          f"{plain['ce']} by {ce_err:.3e} > {ce_tol} (relative)")
    kind, tol = MESH_TRAIN["grad_tol"][name]
    grad_err = max(rec["grad_errs"]["max"] for rec in ranks)
    worst = max((row for rec in ranks for row in rec["grad_errs"]["worst"]),
                key=lambda row: row["err"])
    check(all(rec["grad_errs"]["finite"] for rec in ranks),
          f"{label}: a gradient is not finite")
    check(grad_err <= tol,
          f"{label}: step 0's gradient blocks differ from the no-mesh "
          f"run's by {grad_err:.3e} > {tol} ({kind}, worst leaf)")
    flash = ranks[0]["flash_parity"]
    want = {k: v * counted for k, v in _mt_flash_want(cfg, part).items()}
    check(bool(flash) == bool(want["flash_attention"]),
          f"{label}: {len(flash)} distinct flash calls held against their "
          f"plain versions, {want['flash_attention']} launches expected")
    for r, rec in enumerate(ranks):
        got = {k: rec["launches"][k] for k in NO_LM}
        check(got == want, f"{label}: rank {r} launches {got} != {want} (with "
              f"remat the forward twice a self-attention layer a step, "
              f"whisper's encoder once, the backward once, on the rank's "
              f"heads)")
    launches = {k: v // counted for k, v in want.items() if v}
    ms = [rec["ms"] for rec in ranks]
    moved = ranks[0]["moved_bytes_per_step"]
    coll = [rec["collective_ms_per_step"] for rec in ranks]
    out = {"arch": part["arch"], "n_layers": layers, "dtype": part["dtype"],
           "cuts": part["cuts"], "mesh": sizes, "steps": steps,
           "ce": ces[0], "plain_ce": plain["ce"], "ce_rel_err": ce_err,
           "gnorm": ranks[0]["gnorm"], "plain_gnorm": plain["gnorm"],
           "step0": ranks[0]["step0"], "plain_step0": ranks[0]["plain_step0"],
           "grad_err": grad_err, "grad_err_kind": kind, "grad_tol": tol,
           "grad_worst_by_rank": [r["grad_errs"]["worst"] for r in ranks],
           "ms_per_step_by_rank": ms, "plain_ms_per_step": plain["ms"],
           "launches_per_step_per_rank": launches,
           "moved_bytes_per_step": moved,
           "collective_ms_per_step_by_rank": coll,
           "param_bytes_per_rank": [r["param_bytes"] for r in ranks],
           "state_bytes_per_rank": [r["state_bytes"] for r in ranks],
           "plain_param_bytes": plain["param_bytes"],
           "peak_bytes_per_rank": [r["peak_bytes"] for r in ranks],
           "plain_peak_bytes": plain["peak_bytes"],
           "flash_parity": flash}
    log(f"[mesh train] ({name}) {part['arch']} {layers} layers {part['dtype']}"
        f" {part['cuts'] or ''} on {sizes}, {MESH_TRAIN['batch']} x "
        f"{part.get('seq', MESH_TRAIN['seq'])} tokens, "
        f"{steps or 'no AdamW (step 0 alone)'} steps: CE " + " ".join(
            f"{c:.5f}" for c in ces[0]) + " on every rank (no mesh "
        + " ".join(f"{c:.5f}" for c in plain["ce"]) + f"; worst relative "
        f"{ce_err:.2e}, tol {ce_tol}); step 0's gradient blocks {kind} "
        f"{grad_err:.2e} (tol {tol}; worst leaf {worst['leaf']}"
        + (f", its relative norm error against the float32 gradient "
           f"{worst['mesh_vs_f32']:.2e} with the mesh, "
           f"{worst['no_mesh_vs_f32']:.2e} without" if "mesh_vs_f32" in worst
           else "") + "); gnorm " + " ".join(
            f"{g:.4f}" for g in ranks[0]["gnorm"]))
    log(f"[mesh train]   ms a step by rank " + "; ".join(
        " / ".join(f"{x:.0f}" for x in m) for m in ms) + " (no mesh "
        + " / ".join(f"{x:.1f}" for x in plain["ms"]) + "); a step a rank "
        + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in moved.items() if v)
        + " through the collectives, host ms in them (rank 0) "
        + ", ".join(f"{k} {v:.0f}" for k, v in coll[0].items() if v))
    log(f"[mesh train]   parameter bytes a rank " + " / ".join(
        f"{r['param_bytes'] / 1e9:.3f}" for r in ranks) + " GB and moments "
        + " / ".join(f"{r['state_bytes'] / 1e9:.3f}" for r in ranks)
        + f" GB (the layout's; whole {plain['param_bytes'] / 1e9:.3f} GB); "
        f"peak " + " / ".join(f"{r['peak_bytes'] / 2**30:.2f}" for r in ranks)
        + f" GiB a rank (no mesh {plain['peak_bytes'] / 2**30:.2f}); flash a "
        f"step a rank {launches}; " + "; ".join(
            f"{row['route']} forward at q {row['q']} k {row['k']} causal "
            f"{row.get('causal', True)} window {row.get('window')} within "
            f"{row['forward_max_abs_err']:.2e} of its plain version, the "
            f"{row['bwd_route']} backward "
            f"{max(row['backward_rel_err'].values()):.2e}" for row in flash)
        + f"; 4 ranks share one card and gloo stages through the host, so "
        f"these times say nothing of 4 cards; on {card}")
    return out


# ---------------------------------------------------------------------------

def _timed(seconds: dict, key: str, fn, *args):
    """fn(*args), its wall seconds logged and kept under ``key``."""
    t0 = time.perf_counter()
    out = fn(*args)
    seconds[key] = time.perf_counter() - t0
    log(f"[time] {key}: {seconds[key]:.1f} s")
    return out


def main() -> int:
    seconds = {}
    card = phase_device()
    record = {"card": card, "phase_seconds": seconds,
              "build": _timed(seconds, "build", phase_build),
              "parity_max_abs_err": _timed(seconds, "parity", phase_parity),
              "quickstart": _timed(seconds, "quickstart", phase_quickstart)}
    record["full_size"], susy = _timed(seconds, "full_size", phase_full_size)
    record["covtype"] = _timed(seconds, "covtype", phase_covtype)
    record["table_one"] = _timed(seconds, "table_one", phase_table_one, *susy)
    record["async"] = _timed(seconds, "async", phase_async, *susy)
    record["populations"] = _timed(seconds, "populations", phase_populations)
    record["telemetry"] = _timed(seconds, "telemetry", phase_telemetry, card,
                                 *susy, record["populations"])
    record["dynamics"] = _timed(seconds, "dynamics", phase_dynamics, card,
                                *susy, record["populations"]["dynamics"])
    record["distributed"] = _timed(seconds, "distributed", phase_distributed,
                                   card)
    record["client_mesh"] = _timed(seconds, "client_mesh", phase_client_mesh,
                                   card)
    record["long_rows"] = _timed(seconds, "long_rows", phase_long_rows)
    record["codec_parity_max_abs_err"] = _timed(seconds, "codec_parity",
                                                phase_codec_parity)
    record["transport"] = _timed(seconds, "transport", phase_transport, *susy)
    del susy
    torch.cuda.empty_cache()
    record["flash_parity"] = _timed(seconds, "flash_parity", phase_flash_parity)
    record["serve"] = _timed(seconds, "serve", phase_serve)
    record["serve_f32"] = _timed(seconds, "serve_f32", phase_serve_f32)
    record["recurrent"] = _timed(seconds, "recurrent", phase_recurrent, card)
    record["moe"] = _timed(seconds, "moe", phase_moe, card)
    record["cross"] = _timed(seconds, "cross", phase_cross, card)
    record["rightsized"] = _timed(seconds, "rightsized", phase_rightsized, card)
    record["mesh_serving"] = _timed(seconds, "mesh_serving", phase_mesh_serving,
                                    card)
    record["mesh_recurrent"] = _timed(seconds, "mesh_recurrent",
                                      phase_mesh_serving, card, "11g")
    record["mesh_rings_cross"] = _timed(seconds, "mesh_rings_cross",
                                        phase_mesh_serving, card, "11h")
    record["flash_times"] = _timed(seconds, "flash_times", phase_flash_times)
    record["train"] = _timed(seconds, "train", phase_train)
    record["mesh_train"] = _timed(seconds, "mesh_train", phase_mesh_train, card)
    # launches: the SRHT kernels from the full-size comm=None run (fwht is
    # the butterfly they share and is never launched on its own there),
    # the codec kernels from the two full-size transport runs, the
    # wgmma flash kernel from the bf16 engine run of the serve phase and
    # the tf32x3 one from the f32 engine run, the backward from the bf16
    # training run (one call of its sm90 route a layer a step) and the
    # tf32x3 backward from the f32 twin's
    train = record["train"]
    bwd_rows = train["flash_bwd"]["rows"]
    launches = {**record["full_size"]["launches"],
                **record["transport"]["launches"],
                "flash_attention_sm90":
                    record["serve"]["launches"]["flash_attention_sm90"],
                "flash_attention_tf32x3":
                    record["serve_f32"]["launches"]["flash_attention_tf32x3"],
                **{f"flash_attention_bwd_{route}": train[dt]["launches"][
                    f"flash_attention_bwd_{route}"]
                   for route, dt in (("sm90", "bf16"), ("tf32x3", "f32"))}}
    # the backward's main rows: the training shape in bf16 (sm90) and in
    # float32 (tf32x3, the f32 twin's shape)
    train_rows = {r["dtype"]: r for r in bwd_rows
                  if r["dims"] == list(FLASH_BWD_SHAPES[TRAIN_SHAPE][1])}
    timed = {**record["full_size"]["kernels"],
             **record["transport"]["kernels"], **record["flash_times"],
             "flash_attention_bwd_sm90": [train_rows["bfloat16"]],
             "flash_attention_bwd_tf32x3": [train_rows["float32"]]}
    parity = {**record["parity_max_abs_err"],
              **record["codec_parity_max_abs_err"],
              **{f"flash_attention_{route}": max(
                  e for key, e in record["flash_parity"]["worst"].items()
                  if key.startswith(route)) for route in ("sm90", "tf32x3")},
              **{f"flash_attention_bwd_{route}": max(
                  r["max_abs_err"] for r in bwd_rows if r["route"] == route)
                 for route in BWD_ROUTE_KERNELS}}
    for name, err in record["long_rows"]["max_abs_err"].items():
        parity[name] = max(parity[name], err)
    # the routes of srht_apply and fwht, each at a timed shape, with the
    # launches of the main-path run that takes it (SUSY: the warp route;
    # covtype: the register route)
    long_times = record["long_rows"]["timings"]
    covtype = record["covtype"]["srht_apply"]
    # srht_apply_rows: SUSY's per-client call, launched by FedNS and
    # FedNDES in 5c; covtype's (not on a path here); the quickstart's,
    # launched by FedNS under the transport. Each beside the parent's
    # route (the copy, then the batched srht_apply kernel), a route of
    # srht_apply that takes what srht_rows_kernel does not
    table = record["table_one"]
    batched = table["srht_apply_rows"]
    sketched = {op: sum(table["optimizers"][name]["launches"][op]
                        for name in SKETCHED)
                for op in ("srht_apply", "srht_apply_rows")}
    transport = table["fedns_transport"]["launches"]
    launches["srht_apply_rows"] = sketched["srht_apply_rows"]
    timed["srht_apply_rows"] = batched
    parity["srht_apply_rows"] = max(parity["srht_apply_rows"],
                                    *(r["max_abs_err"] for r in batched))
    routes = {
        "srht_apply": [(timed["srht_apply"][0], launches["srht_apply"]),
                       (covtype[0], record["covtype"]["launches"]["srht_apply"]),
                       (covtype[-1], 0),
                       *[(r, 0) for r in long_times if r["op"] == "srht_apply"],
                       (batched[0]["parent"], sketched["srht_apply"]
                        - sketched["srht_apply_rows"]),
                       (batched[1]["parent"], 0),
                       (batched[2]["parent"], transport["srht_apply"]
                        - transport["srht_apply_rows"])],
        "srht_apply_rows": [(batched[0], sketched["srht_apply_rows"]),
                            (batched[1], 0),
                            (batched[2], transport["srht_apply_rows"])],
        "fwht": [*[(r, 0) for r in timed["fwht"]],
                 *[(r, 0) for r in long_times if r["op"] == "fwht"]],
    }
    kernels = []
    for name, meta in KERNELS.items():
        main_row = timed[name][0]
        entry = {
            "name": name, "route": "cuda", **meta,
            "launches": launches[name],
            "max_abs_err": max(main_row["max_abs_err"], parity[name]),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
        }
        if name in DIST_LAUNCHES:
            # phase 5h: launches a round a rank of DistributedFLeNS
            dist_rec = record["distributed"]
            entry["distributed_launches_per_round"] = {
                "one_rank_nccl":
                    dist_rec["one_rank"]["launches_per_round"][name],
                "four_ranks_gloo": [
                    r[name] for r in
                    dist_rec["four_ranks"]["launches_per_round"]]}
        if name in CM_KERNELS:
            # phase 5i: launches of the population runs split over ranks
            cm = record["client_mesh"]
            entry["client_mesh_launches"] = {
                "one_rank_nccl": cm["one_rank"]["launches"][name],
                "four_ranks_gloo": [n[name] for n in
                                    cm["four_ranks_sync"]["launches"]],
                "async_four_ranks_gloo": [n[name] for n in
                                          cm["four_ranks_async"]["launches"]]}
        if name in ("flash_attention_sm90", "flash_attention_tf32x3"):
            # phases 11f-11h: launches a prefill a rank of an LM over a
            # mesh, by the part's arch and input
            entry["mesh_launches_per_prefill_per_rank"] = {
                f"{phase} {spec['arch']} {k}":
                    record[key][p][k]["launches_per_prefill"][name]
                for phase, key in (("11f", "mesh_serving"),
                                   ("11g", "mesh_recurrent"),
                                   ("11h", "mesh_rings_cross"))
                for p, spec in MESH_SPECS[phase]["parts"].items()
                if FLASH_ROUTE[MESH_DTYPES[spec["dtype"]]]
                == name.rsplit("_", 1)[1]
                for k, _, _ in spec["inputs"]}
        if name.startswith("flash_attention"):
            # phase 14: launches a training step a rank over a mesh, by
            # part (the forward kernels twice a layer with remat, each
            # backward route once)
            entry["mesh_train_launches_per_step_per_rank"] = {
                f"14 {spec['arch']} {p}":
                    record["mesh_train"][p]["launches_per_step_per_rank"]
                    .get(name, 0)
                for p, spec in MESH_TRAIN["parts"].items()}
        if name in routes:
            entry["routes"] = [
                {"kernel": r["route"], "shape": r["shape"], "dims": r["dims"],
                 "launches": count, "ms": r["ms"], "device_ms": r["device_ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
                for r, count in routes[name]]
        kernels.append(entry)
    print("[record] " + json.dumps(record))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--population-child"]:
        sys.exit(population_child())
    if sys.argv[1:2] == ["--distributed-child"]:
        sys.exit(distributed_child(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--client-mesh-child"]:
        sys.exit(client_mesh_child(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--mesh-serving-child"]:
        sys.exit(mesh_serving_child(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--mesh-train-child"]:
        sys.exit(mesh_train_child(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
