"""STEVESlotFormer on Physion slots (reference video_prediction/configs/slotformer_physion_params.py).

``dec_dict['dec_ckp_path']`` names the trained STEVE checkpoint whose token
decoder (``trans_decoder.*``, grafted as ``decoder.*``) and dVAE
(``dvae.*``) are grafted and frozen at the start of training: a ``.pth`` of
this package's trainer or of the reference, read with ``torch.load``. JAX
``.ckpt.pkl`` files need converting first (not ported yet). The directory
of ``dvae_dict['dvae_ckp_path']`` names the token tree read when
``use_img_recon_loss`` is on.
"""

from slotformer_tpu_torch.runtime.params import BaseParams


class SlotFormerParams(BaseParams):
    project = 'SlotFormer-TPU'

    max_epochs = 25  # ~230k steps
    save_interval = 0.125
    eval_interval = 2
    n_samples = 8

    optimizer = 'Adam'
    lr = 2e-4
    warmup_steps_pct = 0.05

    dataset = 'physion_slots_training'
    data_root = './data/Physion'
    slots_root = './data/Physion/training_slots.pkl'
    tasks = ['all']
    n_sample_frames = 15 + 10  # 15 burn-in + 10 rollout
    frame_offset = 3  # subsample every 3 frames
    video_len = 150
    train_batch_size = 128  # GLOBAL
    val_batch_size = 128
    num_workers = 8

    model = 'STEVESlotFormer'
    resolution = (128, 128)
    input_frames = 15

    num_slots = 6
    slot_size = 192
    slot_dict = dict(num_slots=num_slots, slot_size=slot_size)
    rollout_dict = dict(
        num_slots=num_slots,
        slot_size=slot_size,
        history_len=input_frames,
        t_pe='sin',
        slots_pe='',
        d_model=256,
        num_layers=8,
        num_heads=8,
        ffn_dim=256 * 4,
        norm_first=True,
    )
    dvae_dict = dict(
        down_factor=4,
        vocab_size=4096,
        dvae_ckp_path='pretrained/dvae_physion_params/model.pth',
    )
    dec_dict = dict(
        dec_num_layers=4,
        dec_num_heads=4,
        dec_d_model=slot_size,
        dec_ckp_path='pretrained/steve_physion_params/model.pth',
    )
    loss_dict = dict(
        rollout_len=10,
        use_img_recon_loss=False,  # STEVE img recon is memory-intensive
    )

    slot_recon_loss_w = 1.
    img_recon_loss_w = 1.
