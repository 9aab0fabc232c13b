"""Objective evaluation: SI-SNR, multi-scale mel L1, STOI/ESTOI and PESQ nb/wb."""
