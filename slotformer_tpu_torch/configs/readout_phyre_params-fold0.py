"""PHYRE task-success readout head, fold 0.

Transformer classifier over rolled-out slots at timesteps [0, 3]; values
match phyre_planning/configs/readout_phyre_params-fold0.py in the reference.
"""

from slotformer_tpu_torch.runtime.params import BaseParams

SLOT_SIZE = 128
FPS = 1


class SlotFormerParams(BaseParams):
    project = 'SlotFormer-TPU'
    model = 'PHYREReadout'

    # ---- data: per-action rollout slots from SingleStepSlotFormer
    dataset = 'phyre_rollout_slots'
    data_root = './data/PHYRE'
    slot_root = 'checkpoints/slotformer_phyre_params-fold0/{}_slots'
    resolution = (128, 128)
    fps = FPS
    n_sample_frames = 11 * FPS
    video_len = 11 * FPS
    frame_offset = 1
    phyre_protocal = 'within'
    phyre_fold = 0
    data_ratio = 0.1
    pos_ratio = 0.2
    reverse_color = True
    num_workers = 8
    train_batch_size = 256    # GLOBAL
    val_batch_size = 512

    # ---- model: CLS-token transformer over slots at sel_slots timesteps
    readout_dict = dict(
        num_slots=8,
        slot_size=SLOT_SIZE,
        t_pe='sin',
        d_model=SLOT_SIZE,
        num_layers=4,
        num_heads=8,
        ffn_dim=SLOT_SIZE * 4,
        norm_first=True,
        sel_slots=[0, 3],
    )
    slot_size = SLOT_SIZE
    vqa_loss_w = 1.

    # ---- optimization (the readout trains fast)
    optimizer = 'Adam'
    lr = 1e-3
    warmup_steps_pct = 0.1
    max_epochs = 50
    eval_interval = 2
    n_samples = 25
