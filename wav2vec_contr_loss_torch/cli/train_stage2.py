"""Stage-2 classifier training CLI of the port, over extracted embeddings.

    python -m wav2vec_contr_loss_torch.cli.train_stage2 --emb_dir DIR \\
        --save_dir DIR [--head_type linear|mlp] [--device cpu]

The port of wav2vec_contr_loss_tpu/cli/train_stage2.py: writes
<save_dir>/stage2_binary_head_best.pt beside its .config.json.
"""

from __future__ import annotations

import argparse

from ..config import Stage2Config
from ..eval.extract import load_embeddings
from ..train import train_stage2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--emb_dir", type=str, required=True,
                   help="directory with <split>_embeddings.npy / _labels.npy")
    p.add_argument("--train_split", type=str, default="train")
    p.add_argument("--dev_split", type=str, default="dev")
    p.add_argument("--save_dir", type=str, default="checkpoints_stage2/run")
    p.add_argument("--head_type", type=str, default="linear",
                   choices=["linear", "mlp"])
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--patience", type=int, default=15)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    train_embs, train_labels = load_embeddings(args.emb_dir, args.train_split)
    dev_embs, dev_labels = load_embeddings(args.emb_dir, args.dev_split)
    cfg = Stage2Config(
        head_type=args.head_type, in_dim=train_embs.shape[1],
        hidden_dim=args.hidden_dim, dropout=args.dropout, lr=args.lr,
        weight_decay=args.weight_decay, epochs=args.epochs,
        batch_size=args.batch_size, patience=args.patience, seed=args.seed,
    )
    train_stage2(cfg, train_embs, train_labels, dev_embs, dev_labels,
                 save_dir=args.save_dir, device=args.device)
    print(f"==> Stage-2 training complete. Checkpoints in {args.save_dir}")


if __name__ == "__main__":
    main()
