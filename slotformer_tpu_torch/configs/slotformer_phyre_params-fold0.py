"""SingleStepSlotFormer on PHYRE fold 0 (1-frame conditioning).

Values match video_prediction/configs/slotformer_phyre_params-fold0.py:
50 epochs ~ 300k steps, batch 64, cond_len 6 iterative-overlap context,
8-layer d256 rollouter. ``dec_dict['dec_ckp_path']`` names the trained SAVi
checkpoint (a ``.pth`` of this package's trainer or of the reference) whose
decoder is grafted and frozen at the start of training.
"""

from slotformer_tpu_torch.runtime.params import BaseParams

NUM_SLOTS = 8
SLOT_SIZE = 128
D_MODEL = SLOT_SIZE * 2
FPS = 1


class SlotFormerParams(BaseParams):
    project = 'SlotFormer-TPU'
    model = 'SingleStepSlotFormer'

    # ---- data: per-action slot npys from the SAVi extraction
    dataset = 'phyre_slots'
    data_root = './data/PHYRE'
    slots_root = 'checkpoints/savi_phyre_params-fold0/{}_slots'
    resolution = (128, 128)
    fps = FPS
    n_sample_frames = (1 + 10) * FPS   # 1 burn-in + 10 rollout
    input_frames = 1
    video_len = 11 * FPS
    frame_offset = 1
    phyre_protocal = 'within'
    phyre_fold = 0
    data_ratio = 0.1
    pos_ratio = 0.2
    reverse_color = True
    num_workers = 8
    train_batch_size = 64     # GLOBAL
    val_batch_size = 8        # img recon in eval

    # ---- model
    slot_dict = dict(num_slots=NUM_SLOTS, slot_size=SLOT_SIZE)
    rollout_dict = dict(
        num_slots=NUM_SLOTS,
        slot_size=SLOT_SIZE,
        history_len=1,
        cond_len=6,           # effective context length
        t_pe='sin',
        slots_pe='',
        d_model=D_MODEL,
        num_layers=8,
        num_heads=8,
        ffn_dim=D_MODEL * 4,
        norm_first=True,
    )
    dec_dict = dict(
        dec_channels=(128, 64, 64, 64, 64),
        dec_resolution=(16, 16),
        dec_ks=5,
        dec_norm='',
        dec_ckp_path='pretrained/savi_phyre_params-fold0/model.pth',
    )

    # ---- losses: slot MSE only (dec_res 16 decoding is memory-heavy)
    loss_dict = dict(rollout_len=10, use_img_recon_loss=False)
    use_loss_decay = False    # RPIN-style ramp; fold-dependent benefit
    loss_decay_pct = 0.8
    slot_recon_loss_w = 1.
    img_recon_loss_w = 0.1

    # ---- optimization
    optimizer = 'Adam'
    lr = 2e-4
    warmup_steps_pct = 0.05
    max_epochs = 50
    save_interval = 0.2
    eval_interval = 5
    n_samples = 25
