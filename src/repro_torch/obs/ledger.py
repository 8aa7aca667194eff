"""Per-round communication ledger.

Counterpart of ``repro/obs/ledger.py:28-153`` (``CommsLedger``, with the
tiered store's staging columns). One byte model per run: the
per-client uplink under the run's wire format (a dense delta, the
seed-compressed message of ``core/seedcomm.py``, or the analog AirComp
symbols, costed at their dense-equivalent count), the per-client downlink
(the model broadcast) and the dense baseline; every per-round and
cumulative figure of a history row derives from it. The columns are
deterministic in the round index and the row's own ``m_effective``, so the
engine's rows and ``FedServer``'s host rows agree. Under an energy-gated
wireless scenario (``sim/channel.py``) each row also gets the energy its
transmitting clients spent, and on a tiered run (``sim/tiered.py``) the
round's dominating bucket and the bytes staged for it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.utils.tree import tree_bytes


def _uplink_mode(cfg) -> str:
    """The run's uplink wire format, resolved from the config as the
    aggregation paths resolve it."""
    if cfg.delta_compression == "seed":
        return "seed"
    if cfg.aircomp:
        return "aircomp"
    return "dense"


@dataclass(frozen=True)
class CommsLedger:
    """Static byte model of one experiment's communication. Figures are
    bytes per round unless suffixed ``_client``; ``m`` is the nominal
    cohort size M."""
    m: int                       # nominal sampled cohort size per round
    uplink_client_bytes: int     # per-client uplink under the wire format
    downlink_client_bytes: int   # per-client model broadcast
    dense_client_bytes: int      # dense-delta baseline per client
    mode: str = "dense"          # dense | seed | aircomp
    # energy a transmission debits under an energy-gated ChannelModel (the
    # normalized Eq.-15 budget); 0.0: no energy accounting, no column
    tx_energy_client: float = 0.0

    @classmethod
    def from_run(cls, cfg, params, m: int = None,
                 channel=None) -> "CommsLedger":
        """The ledger of a run: ``params`` fixes the dense byte count (leaf
        element sizes), ``cfg`` the wire format and the seed message's
        geometry (``seedcomm.wire_bytes_model``). ``channel`` (a
        ``sim.ChannelModel``) adds the energy column when its gating is
        on."""
        from repro_torch.core import seedcomm

        dense = tree_bytes(params)
        mode = _uplink_mode(cfg)
        up = seedcomm.wire_bytes_model(cfg) if mode == "seed" else dense
        tx = (float(channel.tx_cost)
              if channel is not None and channel.gated else 0.0)
        return cls(m=int(m if m is not None else cfg.n_participating),
                   uplink_client_bytes=int(up),
                   downlink_client_bytes=int(dense),
                   dense_client_bytes=int(dense), mode=mode,
                   tx_energy_client=tx)

    # -- per-round figures ---------------------------------------------------
    def round_uplink_bytes(self) -> int:
        return self.m * self.uplink_client_bytes

    def round_downlink_bytes(self) -> int:
        return self.m * self.downlink_client_bytes

    def round_dense_bytes(self) -> int:
        return self.m * self.dense_client_bytes

    def compression_ratio(self) -> float:
        """Dense-baseline bytes over wire bytes (≥ 1 on the seed path, 1.0
        dense and AirComp)."""
        return self.round_dense_bytes() / max(1, self.round_uplink_bytes())

    # -- history annotation --------------------------------------------------
    def annotate(self, rows: list, staging: dict = None, *,
                 start_round: int = 0) -> list:
        """Add the ledger columns to history rows in place (and return
        them): per-round ``wire_bytes``, ``dense_bytes``,
        ``downlink_bytes``, the cumulative ``wire_bytes_total`` and
        ``downlink_bytes_total`` (rounds 0..t), ``compression_ratio``, and
        ``wire_bytes_effective`` on rows with ``m_effective`` (only the
        transmitting clients send) and, under energy gating,
        ``energy_spent`` (``m_effective·tx_energy_client``). Event rows
        (rollbacks) and rows without round metrics pass untouched."""
        up, down = self.round_uplink_bytes(), self.round_downlink_bytes()
        for row in rows:
            if ("event" in row or "round" not in row
                    or not ("mean_local_loss" in row
                            or "m_effective" in row)):
                continue
            t = int(row["round"])
            row["wire_bytes"] = up
            row["dense_bytes"] = self.round_dense_bytes()
            row["downlink_bytes"] = down
            row["wire_bytes_total"] = (t + 1) * up
            row["downlink_bytes_total"] = (t + 1) * down
            row["compression_ratio"] = self.compression_ratio()
            if "m_effective" in row:
                row["wire_bytes_effective"] = int(
                    row["m_effective"] * self.uplink_client_bytes)
                if self.tx_energy_client > 0.0:
                    row["energy_spent"] = float(
                        row["m_effective"] * self.tx_energy_client)
            if staging is not None:
                srow = staging.get(t - start_round)
                if srow:
                    row.update(srow)
        return rows

    def manifest(self) -> dict:
        """The ledger as a manifest block (plain JSON types)."""
        d = dataclasses.asdict(self)
        d["round_uplink_bytes"] = self.round_uplink_bytes()
        d["round_downlink_bytes"] = self.round_downlink_bytes()
        d["compression_ratio"] = self.compression_ratio()
        return d
