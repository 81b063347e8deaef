"""CLEVRER VQA over precomputed slots, the port of
``slotformer_tpu/datasets/clevrer_vqa.py``.

Questions are tokenized against the vocab cache (this package's copy,
``cache/CLEVRER_vocab.json``, or one built from the question corpus by
``build_vocab``). Every item is ONE (question[, choice]) row with static
shapes, as ``models.aloe`` expects:

* a descriptive question -> one row, ``label`` = its answer class, its
  tokens padded to ``max_question_len + max_choice_len``;
* a multiple-choice question -> one row per choice, ``label`` 0/1, the
  question padded to ``max_question_len`` then the choice to
  ``max_choice_len``.

Rows carry (scene_index, question_id, choice_id, q_subtype, is_cls), so the
scorers regroup the choices of a question. ``n_sample_frames`` frames are
read ``video_len // n_sample_frames`` apart from a start index: drawn from
the dataset's own ``numpy`` generator in training; at evaluation taken from
``np.random.default_rng((split_seed, scene_index, question_id))``, the same
for every row of a question and in every process. Predictive questions read
the unrolled tail when the stored slots are longer than 150 frames (a
rollout file).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import numpy as np

from ..runtime.datamodule import Dataset
from ..runtime.io import dump_obj, load_obj

_VOCAB_CACHE = osp.join(osp.dirname(osp.realpath(__file__)), "cache",
                        "CLEVRER_vocab.json")

Q_SUBTYPE2ID = {"descriptive": 0, "explanatory": 1, "predictive": 2,
                "counterfactual": 3}


def _vocab_tokenize(text: str):
    """The vocab's normalisation (reference _tokenize_text,
    clevrer_vqa/datasets/clevrer.py:203-212): lowercase, strip '?', split on
    single spaces, drop empties."""
    return [w for w in text.lower().replace("?", "").split(" ") if w]


def build_vocab(data_root: str, splits=("train", "val"),
                save_path: Optional[str] = None) -> dict:
    """The vocab cache of a question corpus: ``q_vocab`` = PAD at 0, then
    every question and choice word sorted; ``a_vocab`` = PAD at 0, then
    every descriptive answer sorted (the rule that gives the shipped cache
    from the full CLEVRER corpus). Raises rather than write an empty one."""
    words, answers = set(), set()
    n_read = 0
    for split in splits:
        qfile = osp.join(data_root, "questions", f"{split}.json")
        if not osp.isfile(qfile):
            continue
        n_read += 1
        for scene in load_obj(qfile):
            for q in scene["questions"]:
                words.update(_vocab_tokenize(q["question"]))
                if q["question_type"] == "descriptive":
                    if "answer" in q:
                        answers.add(str(q["answer"]))
                else:
                    for c in q.get("choices", []):
                        words.update(_vocab_tokenize(c["choice"]))
    if n_read == 0 or not words:
        probed = [osp.join(data_root, "questions", f"{s}.json") for s in splits]
        raise FileNotFoundError(
            f"build_vocab: no question corpus found (probed {probed}); "
            "refusing to write an empty vocab cache")
    vocab = {
        "q_vocab": {"PAD": 0, **{w: i + 1 for i, w in enumerate(sorted(words))}},
        "a_vocab": {"PAD": 0, **{a: i + 1 for i, a in enumerate(sorted(answers))}},
    }
    if save_path:
        dump_obj(vocab, save_path)
    return vocab


class CLEVRERVQASlotsDataset(Dataset):
    """Row-based (question[, choice]) dataset over precomputed slots."""

    def __init__(self, data_root: str, video_slots: dict,
                 vocab_file: str = _VOCAB_CACHE, split: str = "train",
                 max_n_objects: int = 6, video_len: int = 128,
                 n_sample_frames: int = 25, max_question_len: int = 20,
                 max_choice_len: int = 12, shuffle_obj: bool = False,
                 seed: int = 0):
        if split not in ("train", "val", "test"):
            raise ValueError(f"CLEVRER has splits train/val/test, not {split!r}")
        self.data_root = data_root
        self.video_slots = video_slots
        self.split = split
        self.video_len = video_len
        self.n_sample_frames = n_sample_frames
        self.frame_offset = video_len // n_sample_frames
        self.max_question_len = max_question_len
        self.max_choice_len = max_choice_len
        self.shuffle_obj = shuffle_obj
        # training draws (start index, object order, a replacement row);
        # numpy's generators are thread-safe for the loader's thread pool
        self.rng = np.random.default_rng(seed)

        if not osp.isfile(vocab_file):
            print(f"[clevrer_vqa] vocab cache {vocab_file!r} missing: building "
                  f"it from the question corpus under {data_root!r}")
            build_vocab(data_root, save_path=vocab_file)
        vocabs = load_obj(vocab_file)
        self.q_vocab = vocabs["q_vocab"]
        self.answer2label = vocabs["a_vocab"]
        self.label2answer = {v: k for k, v in self.answer2label.items()}

        self.rows = self._build_rows()
        self.max_start = self.video_len - (self.n_sample_frames - 1) * self.frame_offset

    def _tokenize(self, text: str, pad_num: int):
        toks = [self.q_vocab[w] for w in _vocab_tokenize(text)]
        pad_mask = np.ones(pad_num, bool)
        pad_mask[:len(toks)] = False
        toks = toks + [self.q_vocab["PAD"]] * (pad_num - len(toks))
        return np.asarray(toks, np.int32), pad_mask

    def _build_rows(self):
        scenes = load_obj(osp.join(self.data_root, "questions", f"{self.split}.json"))
        L = self.max_question_len + self.max_choice_len
        rows = []
        for scene in scenes:
            meta = dict(video_fn=scene["video_filename"],
                        scene_index=scene["scene_index"])
            for q in scene["questions"]:
                subtype = Q_SUBTYPE2ID[q["question_type"]]
                if q["question_type"] == "descriptive":
                    toks, pad = self._tokenize(q["question"], L)
                    label = int(self.answer2label[q["answer"]]) if "answer" in q else -1
                    rows.append(dict(meta, question_id=q["question_id"],
                                     choice_id=-1, q_subtype=subtype,
                                     is_cls=True, label=label, q_tokens=toks,
                                     q_pad_mask=pad))
                    continue
                q_toks, q_pad = self._tokenize(q["question"], self.max_question_len)
                for choice in q["choices"]:
                    c_toks, c_pad = self._tokenize(choice["choice"], self.max_choice_len)
                    label = (int(choice["answer"] == "correct")
                             if "answer" in choice else 1)
                    rows.append(dict(meta, question_id=q["question_id"],
                                     choice_id=choice["choice_id"],
                                     q_subtype=subtype, is_cls=False,
                                     label=label,
                                     q_tokens=np.concatenate([q_toks, c_toks]),
                                     q_pad_mask=np.concatenate([q_pad, c_pad])))
        return rows

    def __len__(self):
        return len(self.rows)

    def _start_idx(self, row) -> int:
        if self.split == "train":
            return int(self.rng.integers(0, self.max_start))
        split_seed = {"train": 0, "val": 1, "test": 2}[self.split]
        rng = np.random.default_rng((split_seed, row["scene_index"],
                                     row["question_id"]))
        return int(rng.integers(0, self.max_start))

    def _get_slots(self, row, start_idx: int) -> np.ndarray:
        embs = self.video_slots[row["video_fn"]]  # [T, N, C]
        if row["q_subtype"] == 2 and embs.shape[0] > 150:  # the unrolled tail
            start_idx += embs.shape[0] - self.video_len
        embs = embs[start_idx + self.frame_offset * np.arange(self.n_sample_frames)]
        if self.shuffle_obj:
            embs = embs[:, self.rng.permutation(embs.shape[1])]
        return np.ascontiguousarray(embs.astype(np.float32))

    def _rand_another(self, row_is_cls: bool):
        same_type = [i for i, r in enumerate(self.rows) if r["is_cls"] == row_is_cls]
        return self[int(self.rng.choice(same_type))]

    def __getitem__(self, idx):
        row = self.rows[idx]
        start_idx = self._start_idx(row)
        try:
            video_emb = self._get_slots(row, start_idx)
        except KeyError:
            if self.split != "test":
                return self._rand_another(row["is_cls"])
            # test: keep the question, borrow another video's slots
            video_emb = self._rand_another(row["is_cls"])["video_emb"]
        return {
            "video_emb": video_emb,
            "q_tokens": row["q_tokens"],
            "q_pad_mask": row["q_pad_mask"],
            "is_cls": row["is_cls"],
            "label": np.int32(max(row["label"], 0)),
            "raw_label": np.int32(row["label"]),
            "q_subtype": np.int32(row["q_subtype"]),
            "scene_index": np.int32(row["scene_index"]),
            "question_id": np.int32(row["question_id"]),
            "choice_id": np.int32(row["choice_id"]),
            "data_idx": idx,
        }

    def get_answer_from_label(self, answer_labels: np.ndarray) -> np.ndarray:
        flat = answer_labels.flatten()
        return np.array([self.label2answer[int(x)] for x in flat]).reshape(
            answer_labels.shape)


def build_clevrer_vqa_dataset(params, val_only=False, test_set=False):
    """(train, val), val alone with ``val_only``, or the test split with
    ``test_set`` (objects never shuffled)."""
    video_slots = load_obj(params.slots_root)
    args = dict(
        data_root=params.data_root,
        vocab_file=params.get("vocab_file", _VOCAB_CACHE),
        max_n_objects=params.max_n_objects,
        video_len=params.get("video_len", 128),
        n_sample_frames=params.n_sample_frames,
        max_question_len=params.max_question_len,
        max_choice_len=params.max_choice_len,
        shuffle_obj=params.get("shuffle_obj", False),
        seed=int(params.get("seed", 0)),
    )
    if test_set:
        return CLEVRERVQASlotsDataset(video_slots=video_slots["test"],
                                      **dict(args, split="test", shuffle_obj=False))
    val_dataset = CLEVRERVQASlotsDataset(video_slots=video_slots["val"],
                                         **dict(args, split="val"))
    if val_only:
        return val_dataset
    train = CLEVRERVQASlotsDataset(video_slots=video_slots["train"],
                                   **dict(args, split="train"))
    return train, val_dataset
