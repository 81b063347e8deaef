"""SAVi on PHYRE fold 0 (reference base_slots/configs/savi_phyre_params-fold0.py).
For another fold, copy it with ``phyre_fold`` changed: that fold's splits
are drawn from the phyre cache on first use."""

from slotformer_tpu_torch.runtime.params import BaseParams


class SlotFormerParams(BaseParams):
    project = 'SlotFormer-TPU'

    max_epochs = 30  # ~370k steps
    save_interval = 0.2
    eval_interval = 2
    n_samples = 25  # 25 PHYRE tasks

    optimizer = 'Adam'
    lr = 1e-4
    clip_grad = 0.05
    warmup_steps_pct = 0.025

    dataset = 'phyre'
    data_root = './data/PHYRE'
    n_sample_frames = 6
    fps = 1
    video_len = 15 * fps
    frame_offset = 1  # compat only; modify fps instead
    phyre_protocal = 'within'
    phyre_fold = 0
    data_ratio = 0.1   # 10% of the data
    pos_ratio = 0.2    # balanced pos/neg actions, following RPIN
    reverse_color = True  # black background helps SAVi on light objects

    # batch 32 beats 64 for SAVi here (gradient randomness helps decomposition)
    train_batch_size = 32  # GLOBAL
    val_batch_size = 48
    num_workers = 8

    model = 'StoSAVi'
    resolution = (128, 128)
    input_frames = n_sample_frames

    slot_dict = dict(
        num_slots=8,
        slot_size=128,
        slot_mlp_size=256,
        num_iterations=2,
    )
    enc_dict = dict(
        enc_channels=(3, 64, 64, 64, 64),
        enc_ks=5,
        enc_out_channels=128,
        enc_norm='',
    )
    dec_dict = dict(
        dec_channels=(128, 64, 64, 64, 64),
        dec_resolution=(16, 16),  # larger broadcast grid for small objects
        dec_ks=5,
        dec_norm='',
    )
    pred_dict = dict(
        pred_type='transformer',
        pred_rnn=True,
        pred_norm_first=True,
        pred_num_layers=2,
        pred_num_heads=4,
        pred_ffn_dim=128 * 4,
        pred_sg_every=None,
    )
    loss_dict = dict(
        use_post_recon_loss=True,
        kld_method='none',
    )

    post_recon_loss_w = 1.
    kld_loss_w = 1e-4
