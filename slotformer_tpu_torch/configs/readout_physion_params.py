"""Physion VQA relation-network readout.

Values match physion_vqa/configs/readout_physion_params.py in the reference.
Trains on the first 75 frames only — later rollout frames accumulate
artifacts the head would overfit to.
"""

from slotformer_tpu_torch.runtime.params import BaseParams

SLOT_SIZE = 192


class SlotFormerParams(BaseParams):
    project = 'SlotFormer-TPU'
    model = 'PhysionReadout'

    # ---- data: whole-video (slots, label) pairs from the readout subset
    dataset = 'physion_slots_label_readout'
    data_root = './data/Physion'
    slots_root = 'checkpoints/slotformer_physion_params/readout_slots.pkl'
    tasks = ['all']
    resolution = (128, 128)
    n_sample_frames = 6       # unused for whole-video items
    frame_offset = 1
    video_len = 75
    num_workers = 8
    train_batch_size = 64     # GLOBAL
    val_batch_size = 128

    # ---- model: all C(N,2) slot pairs -> max over pairs -> max over time
    slot_size = SLOT_SIZE
    readout_dict = dict(
        num_slots=6,
        slot_size=SLOT_SIZE,
        agg_func='max',
        feats_dim=SLOT_SIZE,
    )
    vqa_loss_w = 1.

    # ---- optimization (no warmup)
    optimizer = 'Adam'
    lr = 1e-3
    warmup_steps_pct = 0.
    max_epochs = 50
    eval_interval = 5
    n_samples = 8
