"""Experiment storage: CSV/JSON statistics and folder layout
(``howtotrainyourmamlpytorch_tpu/utils/storage.py``, after the original
PyTorch implementation's ``utils/storage.py:8-128``): CSV row
append/create + column-dict load, the
``<name>/{saved_models,logs,visual_outputs}`` experiment folder layout, and
JSON log helpers.
"""

from __future__ import annotations

import csv
import datetime
import json
import os


def save_to_json(filename: str, dict_to_store, default=None) -> None:
    """Atomic JSON write (temp file + ``os.replace``) — the same contract
    ``save_checkpoint`` honors. The previous truncate-then-write destroyed
    ``summary_statistics.json`` / ``experiment_log.json`` permanently on any
    crash mid-dump."""
    path = os.path.abspath(filename)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(dict_to_store, f, default=default)
    os.replace(tmp, path)


def load_from_json(filename: str):
    with open(filename) as f:
        return json.load(f)


def save_statistics(
    experiment_name: str,
    line_to_add,
    filename: str = "summary_statistics.csv",
    create: bool = False,
) -> str:
    """Appends (or creates with) one CSV row (reference ``:18-29``)."""
    summary_filename = f"{experiment_name}/{filename}"
    with open(summary_filename, "w" if create else "a", newline="") as f:
        csv.writer(f).writerow(line_to_add)
    return summary_filename


def load_statistics(
    experiment_name: str, filename: str = "summary_statistics.csv"
) -> dict:
    """Loads a stats CSV into ``{column: [values...]}`` (reference ``:31-46``)."""
    summary_filename = f"{experiment_name}/{filename}"
    with open(summary_filename) as f:
        lines = [line.rstrip("\n") for line in f]
    data_labels = lines[0].split(",")
    data_dict: dict = {label: [] for label in data_labels}
    for line in lines[1:]:
        for key, item in zip(data_labels, line.split(",")):
            data_dict[key].append(item)
    return data_dict


def build_experiment_folder(experiment_name: str):
    """Creates ``<name>/{saved_models,logs,visual_outputs}`` (reference
    ``:49-66``). Returns their absolute paths."""
    experiment_path = os.path.abspath(experiment_name)
    saved_models = os.path.join(experiment_path, "saved_models")
    logs = os.path.join(experiment_path, "logs")
    samples = os.path.join(experiment_path, "visual_outputs")
    for path in (experiment_path, logs, samples, saved_models):
        os.makedirs(path, exist_ok=True)
    return saved_models, logs, samples


def create_json_experiment_log(
    experiment_log_dir: str, args, log_name: str = "experiment_log.json"
) -> None:
    """Initializes the experiment JSON log (reference ``:82-96``)."""
    summary_filename = f"{experiment_log_dir}/{log_name}"
    summary = dict(vars(args))
    summary["epoch_stats"] = {}
    timestamp = datetime.datetime.now().timestamp()
    summary["experiment_status"] = [(timestamp, "initialization")]
    summary["experiment_initialization_time"] = timestamp
    save_to_json(summary_filename, summary, default=str)


def update_json_experiment_log_dict(
    key: str, value, experiment_log_dir: str, log_name: str = "experiment_log.json"
) -> None:
    summary_filename = f"{experiment_log_dir}/{log_name}"
    summary = load_from_json(summary_filename)
    summary[key].append(value)
    save_to_json(summary_filename, summary)


def update_json_experiment_log_epoch_stats(
    epoch_stats: dict, experiment_log_dir: str, log_name: str = "experiment_log.json"
) -> str:
    """Appends one epoch's scalar stats to the JSON log (reference
    ``:113-128``)."""
    summary_filename = f"{experiment_log_dir}/{log_name}"
    summary = load_from_json(summary_filename)
    epoch_stats_dict = summary["epoch_stats"]
    for key, value in epoch_stats.items():
        epoch_stats_dict.setdefault(key, []).append(float(value))
    save_to_json(summary_filename, summary)
    return summary_filename
