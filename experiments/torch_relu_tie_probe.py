#!/usr/bin/env python3
"""How often a ReLU tie moves the Aloe step's card-against-CPU gradient.

    python3 experiments/torch_relu_tie_probe.py   # repository root, one card

Runs ``chip_smoke.py``'s phases ``train`` to ``vqa`` (its StoSAVi and
SlotFormer fits, then the CLEVRER-shaped slots and questions), then takes
the Aloe B=2 step of ``phase_vqa`` on the card and on the CPU for 4 model
seeds x 12 (descriptive, choice) row pairs: once with each device deciding
its own ReLUs, once through ``chip_smoke._tied_pair``. Prints one JSON line
per step and a summary: the worst gradient error against the parameter's
largest entry, as ``chip_smoke._grad_errors`` measures it, with and without
the ties, and the steps past ``VQA_GRAD_RTOL``.
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.kernels import build
    from slotformer_tpu_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    rows_out = []
    with tempfile.TemporaryDirectory() as workdir:
        _, savi = cs.phase_train(os.path.join(workdir, "stosavi_train"))
        slots_path, savi_ckp, _ = cs.phase_slots_file(workdir)
        sf = cs.phase_train_slotformer(slots_path, savi_ckp, workdir)
        cs.phase_vqa(workdir, savi, sf)
        root = os.path.join(workdir, "data", "CLEVRER")
        _, params = cs.derived_params(
            workdir, "aloe_clevrer_params", data_root=root,
            slots_root=os.path.join(root, "clevrer_slots.pkl"), num_workers=4)
        weights = params.loss_weights()
        train_set, _ = build_dataset(params)
        cls_rows = [i for i, r in enumerate(train_set.rows) if r["is_cls"]]
        mc_rows = [i for i, r in enumerate(train_set.rows) if not r["is_cls"]]

        def step(m, batch, dev):
            m.zero_grad(set_to_none=True)
            losses = m.train_loss({k: v.to(dev) for k, v in batch.items()})
            sum(weights.get(n, 1.0) * v for n, v in losses.items()).backward()
            return ({n: v.item() for n, v in losses.items()},
                    {n: p.grad.detach().cpu() for n, p in m.named_parameters()})

        def errors(card, cpu):
            (l_card, g_card), (l_cpu, g_cpu) = card, cpu
            loss_err = max(abs(l_card[n] / l_cpu[n] - 1) for n in l_cpu)
            return (loss_err,) + cs._grad_errors(g_card, g_cpu)

        for seed in (13, 14, 15, 16):
            torch.manual_seed(seed)
            gpu = build_model(params, device=cs.DEVICE)
            cpu = build_model(params, device="cpu")
            cpu.load_state_dict(gpu.state_dict())
            gpu.eval()
            cpu.eval()
            for p in range(12):
                rows = [cls_rows[p % len(cls_rows)], mc_rows[3 * p % len(mc_rows)]]
                items = [train_set[i] for i in rows]
                batch = {k: torch.from_numpy(np.stack([np.asarray(it[k]) for it in items]))
                         for k in ("video_emb", "q_tokens", "q_pad_mask", "is_cls",
                                   "label")}
                own = errors(step(gpu, batch, cs.DEVICE), step(cpu, batch, "cpu"))
                card, host, ties = cs._tied_pair(lambda: step(gpu, batch, cs.DEVICE),
                                                 lambda: step(cpu, batch, "cpu"))
                tied = errors(card, host)
                r = dict(seed=seed, rows=rows, loss_rel_err=own[0],
                         grad_rel_err=own[1], worst=own[2], tied_loss_rel_err=tied[0],
                         tied_grad_rel_err=tied[1], tied_worst=tied[2], **ties)
                rows_out.append(r)
                print(json.dumps(r), flush=True)
    worst = max(r["grad_rel_err"] for r in rows_out)
    print(json.dumps(dict(
        steps=len(rows_out),
        steps_with_untied_units=sum(r["untied"] > 0 for r in rows_out),
        grad_rel_err_max=worst,
        tied_grad_rel_err_max=max(r["tied_grad_rel_err"] for r in rows_out),
        untied_rel_x_max=max(r["untied_rel_x"] for r in rows_out),
        steps_past_tol=sum(r["grad_rel_err"] > cs.VQA_GRAD_RTOL for r in rows_out),
        tied_steps_past_tol=sum(r["tied_grad_rel_err"] > cs.VQA_GRAD_RTOL
                                for r in rows_out))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
